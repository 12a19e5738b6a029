"""Oxford RobotCar train/eval entry point of the port (counterpart of the
root ``train_OxfordRobotCar.py``, with its flags, defaults, label,
checkpoint directory, results files and printed eval lines):

    python -m ccvpe_torch.train_OxfordRobotCar --grd_image_root datasets/Oxford_5m_sampling/
    python -m ccvpe_torch.train_OxfordRobotCar --training False --test_model_path model.pt

``--grd_image_root`` ends with ``/``, as the reference's loaders expect.
Training runs 50 epochs with a validation pass after each;
``--training False`` evaluates the three test traversals one by one
(per-frame pose, reference ``:74-83, 209-397``).  Runs on ``cuda``;
``CCVPE_PLATFORM=cpu`` runs on the CPU.  Under
``torchrun --nproc_per_node N -m ...`` it runs one process per card,
data-parallel, ``-b`` the global batch (``train.cli.run_main``).
"""

import argparse
import os

import numpy as np

from .train import cli
from .utils.platform import env_device


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--grd_image_root", type=str,
                   default=os.environ.get("OXFORD_ROOT", "datasets/Oxford_5m_sampling/"))
    p.add_argument("--sat_path", type=str, default="")
    p.add_argument("--model_preset", type=str, default="OxfordRobotCar")
    cli.add_common_flags(p, test_model_path="models/OxfordRobotCar/model.pt", epochs=50,
                         cache_help="build/use a preprocessed uint8 cache of the ground "
                                    "frames (the aerial side is already one in-memory map)")
    return p.parse_args(argv)


def main(argv=None):
    return cli.run_main(_main, argv)


def _main(argv=None):
    args = parse_args(argv)
    training = args.training == "True"
    label = "OxfordRobotCar"
    sat_path = args.sat_path or os.path.join(args.grd_image_root, "satellite_map_new.png")

    from .data import oxford, pipeline
    from .models import cvm
    from .train.metrics import OXFORD_METER_PER_PIXEL

    device = env_device()
    if args.model_preset not in cvm.PRESETS:
        raise SystemExit(f"unknown --model_preset {args.model_preset!r}; "
                         f"choose from {sorted(cvm.PRESETS)}")
    cfg = cvm.PRESETS[args.model_preset]
    trainer = cli.make_trainer(cfg, args, label=label,
                               checkpoint_dir=f"models/OxfordRobotCar/{label}", device=device)
    dev_train = lambda raw: oxford.device_batch(raw, train=True, sat_hw=cfg.sat_hw,
                                                bins=cfg.bins, device=device)
    dev_eval = lambda raw: oxford.device_batch(raw, train=False, sat_hw=cfg.sat_hw,
                                               bins=cfg.bins, device=device)

    def sampler_for(split):
        index = oxford.OxfordIndex.load(args.grd_image_root, sat_path, split)
        sampler = oxford.OxfordSampler(index, grd_hw=cfg.grd_hw, sat_hw=cfg.sat_hw)
        if args.cache_dir:
            from .data.cache import build_or_open

            paths = [sampler.grd_path(i) for i in range(len(index))]
            prefix = os.path.join(args.cache_dir, f"Oxford_{split}_grd")
            sampler.grd_cache = build_or_open(paths, cfg.grd_hw, prefix, progress=True)
        return sampler

    if training:
        train_sampler, val_sampler = sampler_for("train"), sampler_for("val")
        cli.start_training(trainer, args)
        indices = cli.limit(np.arange(len(train_sampler.index)), args)
        for epoch, order in cli.epoch_orders(trainer, indices, args.epochs):
            train_sampler.set_epoch(epoch)  # fresh per-epoch augmentation draws
            loader = pipeline.Loader(train_sampler, order, args.batch_size, args.num_workers,
                                     multihost=True, native_batch=args.native_loader or None,
                                     fast_decode=args.fast_decode or None)
            pps = trainer.train_epoch(loader, dev_train, epoch)
            print(f"epoch {epoch}: {pps:.1f} train pairs/s")
            val_loader = pipeline.Loader(val_sampler,
                                         cli.limit(np.arange(len(val_sampler.index)), args),
                                         args.batch_size, args.num_workers, multihost=True)
            summary = trainer.evaluate(val_loader, dev_eval,
                                       meter_per_pixel=OXFORD_METER_PER_PIXEL)
            print(f"epoch {epoch} validation: {summary}")
            trainer.write_epoch_results(epoch, summary)
        print("Finished Training")
        return None

    sampler = sampler_for("test")
    cli.load_eval_model(trainer, args.test_model_path)
    results = {}
    start = 0
    for t, length in enumerate(sampler.index.traversal_lengths, 1):
        idx = cli.limit(np.arange(start, start + length), args)
        start += length
        loader = pipeline.Loader(sampler, idx, args.batch_size, args.num_workers, multihost=True)
        summary = trainer.evaluate(loader, dev_eval, meter_per_pixel=OXFORD_METER_PER_PIXEL,
                                   with_heading=True)
        results[f"test{t}"] = summary
        # the reference's per-traversal metrics
        # (``train_OxfordRobotCar.py:250-266``)
        print("---------------------------------------")
        print(f"Test traversal {t}")
        print("mean error (m): ", summary["mean_distance_m"])
        print("median error (m): ", summary["median_distance_m"])
        print("mean longitudinal error (m): ", summary.get("mean_longitudinal_m"))
        print("median longitudinal error (m): ", summary.get("median_longitudinal_m"))
        print("mean lateral error (m): ", summary.get("mean_lateral_m"))
        print("median lateral error (m): ", summary.get("median_lateral_m"))
        print("mean orientation error (deg): ", summary.get("mean_orientation_deg"))
        print("median orientation error (deg): ", summary.get("median_orientation_deg"))
        print("percentage of samples with longitudinal localization error under 1m, 3m, "
              "and 5m: ", summary.get("longitudinal_recall@1m"),
              summary.get("longitudinal_recall@3m"), summary.get("longitudinal_recall@5m"))
        print("percentage of samples with lateral localization error under 1m, 3m, and 5m: ",
              summary.get("lateral_recall@1m"), summary.get("lateral_recall@3m"),
              summary.get("lateral_recall@5m"))
        print("percentage of samples with orientation error under 1 degree, 3 degrees, "
              "and 5 degrees: ", summary.get("orientation_recall@1deg"),
              summary.get("orientation_recall@3deg"), summary.get("orientation_recall@5deg"))
        print("throughput (pairs/s): ", summary["pairs_per_sec"])
    return results


if __name__ == "__main__":
    main()
