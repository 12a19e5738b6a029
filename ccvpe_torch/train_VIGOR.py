"""VIGOR train/eval entry point of the port (counterpart of the root
``train_VIGOR.py``, with its flags, defaults, label, checkpoint directory,
results files and printed eval lines):

    python -m ccvpe_torch.train_VIGOR --dataset_root datasets/VIGOR --area samearea
    python -m ccvpe_torch.train_VIGOR --training False --ori_noise 36 \\
        --test_model_path model.pt

Training: 15 epochs of Adam(1e-4) over the reference's 80/20 split, a
checkpoint and validation metrics every epoch.  Eval (``--training
False``): the orientation-prior model (matching bins restricted to
``range(-n, n+1)`` for ``--ori_noise`` = 18n < 180), the frozen test
orientations of the repository's ``fixtures/`` at ``--ori_noise 180``,
and limited-FoV panorama cropping (``-f``).  Runs on ``cuda``;
``CCVPE_PLATFORM=cpu`` runs on the CPU.  Under
``torchrun --nproc_per_node N -m ...`` it runs one process per card,
data-parallel, ``-b`` the global batch (``train.cli.run_main``).
"""

import argparse
import dataclasses
import os

import numpy as np

from .train import cli
from .utils.platform import env_device

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--area", type=str, default="samearea", help="samearea or crossarea")
    p.add_argument("--pos_only", choices=("True", "False"), default="True")
    p.add_argument("-f", "--FoV", type=int, default=360)
    p.add_argument("--ori_noise", type=float, default=180.0,
                   help="orientation prior noise; 180 = unknown orientation")
    p.add_argument("--dataset_root", type=str,
                   default=os.environ.get("VIGOR_ROOT", "datasets/VIGOR"))
    p.add_argument("--orientation_dir", type=str, default="",
                   help="directory holding *_orientation_test.npy fixtures "
                        "(default: the repo's fixtures/, which ships the "
                        "reference release files; falls back to cwd)")
    p.add_argument("--model_preset", type=str, default="VIGOR")
    cli.add_common_flags(p, test_model_path="models/VIGOR/samearea/model.pt", epochs=15,
                         cache_help="build/use preprocessed uint8 array caches "
                                    "(decode-free input streaming)")
    return p.parse_args(argv)


def main(argv=None):
    return cli.run_main(_main, argv)


def _main(argv=None):
    args = parse_args(argv)
    training = args.training == "True"
    pos_only = args.pos_only == "True"
    ori_noise = 18 * (args.ori_noise // 18)  # reference train_VIGOR.py:49
    label = f"{args.area}_HFoV{args.FoV}"
    circular = args.FoV == 360  # reference train_VIGOR.py:52-55

    from .data import pipeline, vigor
    from .models import cvm
    from .train.metrics import VIGOR_METER_PER_PIXEL

    device = env_device()
    if args.model_preset not in cvm.PRESETS:
        raise SystemExit(f"unknown --model_preset {args.model_preset!r}; "
                         f"choose from {sorted(cvm.PRESETS)}")
    cfg = dataclasses.replace(cvm.PRESETS[args.model_preset], circular=circular)
    trainer = cli.make_trainer(cfg, args, label=label, checkpoint_dir=f"models/VIGOR/{label}",
                               device=device)
    grd_hw, sat_hw = cfg.grd_hw, cfg.sat_hw

    def build_caches(index, tag):
        if not args.cache_dir:
            return {}
        from .data.cache import build_or_open

        caches = {}
        for name, paths, hw in (("grd", index.grd_paths, grd_hw),
                                ("sat", index.sat_paths, sat_hw)):
            prefix = os.path.join(args.cache_dir, f"{args.area}_{tag}_{name}")
            caches[f"{name}_cache"] = build_or_open(paths, hw, prefix, progress=True)
        return caches

    def dev_batch(train):
        def fn(raw):
            batch = vigor.device_batch(raw, train=train, sat_hw=sat_hw, bins=cfg.bins,
                                       device=device)
            if args.FoV < 360:
                # the leading FoV/360 of the panorama
                batch["grd"] = batch["grd"][:, :, :int(batch["grd"].shape[2] * args.FoV / 360)]
            return batch
        return fn

    if training:
        index = vigor.VigorIndex.load(args.dataset_root, args.area, True)
        sampler = vigor.VigorSampler(index, pos_only=pos_only, ori_noise=ori_noise,
                                     grd_hw=grd_hw, sat_hw=sat_hw,
                                     **build_caches(index, "train"))
        train_idx, val_idx = pipeline.train_val_split(len(index))
        train_idx, val_idx = cli.limit(train_idx, args), cli.limit(val_idx, args)
        cli.start_training(trainer, args)
        for epoch, order in cli.epoch_orders(trainer, train_idx, args.epochs):
            sampler.set_epoch(epoch)  # fresh per-epoch augmentation draws
            loader = pipeline.Loader(sampler, order, args.batch_size, args.num_workers,
                                     multihost=True, native_batch=args.native_loader or None,
                                     fast_decode=args.fast_decode or None)
            pps = trainer.train_epoch(loader, dev_batch(True), epoch)
            print(f"epoch {epoch}: {pps:.1f} train pairs/s")
            val_loader = pipeline.Loader(sampler, val_idx, args.batch_size, args.num_workers,
                                         multihost=True)
            summary = trainer.evaluate(val_loader, dev_batch(False), meter_per_pixel=None,
                                       cities_to_mpp=VIGOR_METER_PER_PIXEL)
            print(f"epoch {epoch} validation: {summary}")
            trainer.write_epoch_results(epoch, summary)
        print("Finished Training")
        return None

    random_orientation = None
    if ori_noise == 180:  # reference train_VIGOR.py:73-79
        base = f"{args.area}_orientation_test.npy"
        shipped = os.path.join(REPO_ROOT, "fixtures", base)
        candidates = ([os.path.join(args.orientation_dir, base)]
                      if args.orientation_dir else [shipped, base])
        fname = next((c for c in candidates if os.path.exists(c)), None)
        if fname is None:
            raise SystemExit(f"frozen orientation fixture {base} not found in {candidates}; "
                             "pass --orientation_dir (or --ori_noise < 180 for a "
                             "known-orientation prior)")
        random_orientation = np.load(fname)
    index = vigor.VigorIndex.load(args.dataset_root, args.area, False)
    sampler = vigor.VigorSampler(index, pos_only=pos_only, ori_noise=ori_noise,
                                 random_orientation=random_orientation, grd_hw=grd_hw,
                                 sat_hw=sat_hw, **build_caches(index, "test"))
    cli.load_eval_model(trainer, args.test_model_path)
    n = int(ori_noise / 18)
    loc_offsets = tuple(range(-n, n + 1))  # reference models.py:489
    loader = pipeline.Loader(sampler, cli.limit(np.arange(len(index)), args), args.batch_size,
                             args.num_workers, multihost=True)
    summary = trainer.evaluate(loader, dev_batch(False), meter_per_pixel=None,
                               cities_to_mpp=VIGOR_METER_PER_PIXEL, loc_offsets=loc_offsets)
    print("mean localization error (m): ", summary["mean_distance_m"])
    print("median localization error (m): ", summary["median_distance_m"])
    print("---------------------------------------")
    print("mean orientation error (degrees): ", summary.get("mean_orientation_deg"))
    print("median orientation error (degrees): ", summary.get("median_orientation_deg"))
    print("---------------------------------------")
    print("mean probability at gt", summary.get("mean_probability_at_gt"))
    print("median probability at gt", summary.get("median_probability_at_gt"))
    return summary


if __name__ == "__main__":
    main()
