"""KITTI train/eval entry point of the port (counterpart of the root
``train_KITTI.py``, with its flags, defaults, label, checkpoint directory,
results files and printed eval lines):

    python -m ccvpe_torch.train_KITTI --dataset_root datasets/KITTI --rotation_range 10
    python -m ccvpe_torch.train_KITTI --training False --test_model_path model.pt

Training runs 6 epochs with an eval of both test splits after each;
``--training False`` also reports the lateral/longitudinal decomposition
and the <1/3/5 m and degree recalls (reference ``train_KITTI.py:355-360``).
``--device_augment`` runs the aerial alignment chain of training on the
device.  Runs on ``cuda``; ``CCVPE_PLATFORM=cpu`` runs on the CPU.  Under
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
    p.add_argument("--shift_range_lat", type=float, default=20)
    p.add_argument("--shift_range_lon", type=float, default=20)
    p.add_argument("--rotation_range", type=float, default=180)
    p.add_argument("--dataset_root", type=str,
                   default=os.environ.get("KITTI_ROOT", "datasets/KITTI"))
    p.add_argument("--train_file", type=str, default="")
    p.add_argument("--test1_file", type=str, default="")
    p.add_argument("--test2_file", type=str, default="")
    p.add_argument("--device_augment", action="store_true",
                   help="run the aerial alignment chain batched on device "
                        "for training (host only decodes); eval keeps the "
                        "bit-faithful host path")
    p.add_argument("--model_preset", type=str, default="KITTI")
    cli.add_common_flags(p, test_model_path="models/KITTI/no_orientation_prior/model.pt",
                         epochs=6,
                         cache_help="build/use preprocessed uint8 array caches (ground "
                                    "at model size, satmaps raw) for decode-free input "
                                    "streaming")
    return p.parse_args(argv)


def main(argv=None):
    return cli.run_main(_main, argv)


def _main(argv=None):
    args = parse_args(argv)
    training = args.training == "True"
    label = f"KITTI_rotation_range{args.rotation_range}"

    from .data import kitti, pipeline
    from .models import cvm

    device = env_device()
    if args.model_preset not in cvm.PRESETS:
        raise SystemExit(f"unknown --model_preset {args.model_preset!r}; "
                         f"choose from {sorted(cvm.PRESETS)}")
    cfg = cvm.PRESETS[args.model_preset]
    trainer = cli.make_trainer(cfg, args, label=label, checkpoint_dir=f"models/KITTI/{label}",
                               device=device)

    root = args.dataset_root
    train_file = args.train_file or os.path.join(root, "train_files.txt")
    test_files = [args.test1_file or os.path.join(root, "test1_files.txt"),
                  args.test2_file or os.path.join(root, "test2_files.txt")]
    mpp = kitti.meter_per_pixel()
    kw = dict(shift_range_lat=args.shift_range_lat, shift_range_lon=args.shift_range_lon,
              rotation_range=args.rotation_range, grd_hw=cfg.grd_hw, sat_hw=cfg.sat_hw)
    if args.device_augment:
        dev_train = lambda raw: kitti.device_batch_device_aug(
            raw, train=True, mpp=mpp, sat_hw=cfg.sat_hw, bins=cfg.bins, device=device)
    else:
        dev_train = lambda raw: kitti.device_batch(raw, train=True, sat_hw=cfg.sat_hw,
                                                   bins=cfg.bins, device=device)
    dev_eval = lambda raw: kitti.device_batch(raw, train=False, sat_hw=cfg.sat_hw,
                                              bins=cfg.bins, device=device)

    def build_caches(sampler, tag):
        """Ground frames cached at model size; satmaps cached raw (the
        alignment chain needs full resolution; sizes are uniform across the
        KITTI-CVL release)."""
        if not args.cache_dir:
            return
        from PIL import Image

        from .data.cache import build_or_open

        n = len(sampler.index)
        grd_paths = [sampler.grd_path(i) for i in range(n)]
        sat_paths = [sampler.sat_path(i) for i in range(n)]
        with Image.open(sat_paths[0]) as im:
            sat_raw_hw = (im.size[1], im.size[0])
        for name, paths, hw in (("grd", grd_paths, cfg.grd_hw), ("sat", sat_paths, sat_raw_hw)):
            prefix = os.path.join(args.cache_dir, f"KITTI_{tag}_{name}")
            setattr(sampler, f"{name}_cache", build_or_open(paths, hw, prefix, progress=True))

    test_samplers = []
    for tf in test_files:
        if os.path.exists(tf):
            tsampler = kitti.KittiSampler(kitti.KittiIndex.load(root, tf, test=True), **kw)
            build_caches(tsampler, os.path.basename(tf))
            test_samplers.append(tsampler)
        else:
            test_samplers.append(None)

    def eval_split(i, with_heading=False):
        sampler = test_samplers[i]
        if sampler is None:
            return None
        loader = pipeline.Loader(sampler, cli.limit(np.arange(len(sampler.index)), args),
                                 args.batch_size, args.num_workers, multihost=True)
        return trainer.evaluate(loader, dev_eval, meter_per_pixel=mpp, with_heading=with_heading)

    if training:
        index = kitti.KittiIndex.load(root, train_file, test=False)
        sampler = kitti.KittiSampler(index, device_augment=args.device_augment, **kw)
        build_caches(sampler, "train")
        cli.start_training(trainer, args)
        for epoch, order in cli.epoch_orders(trainer, cli.limit(np.arange(len(index)), args),
                                             args.epochs):
            sampler.set_epoch(epoch)  # fresh per-epoch augmentation draws
            loader = pipeline.Loader(sampler, order, args.batch_size, args.num_workers,
                                     multihost=True, native_batch=args.native_loader or None,
                                     fast_decode=args.fast_decode or None)
            pps = trainer.train_epoch(loader, dev_train, epoch)
            print(f"epoch {epoch}: {pps:.1f} train pairs/s")
            for i in range(2):
                summary = eval_split(i)
                if summary:
                    print(f"epoch {epoch} test{i + 1}: {summary}")
                    trainer.write_epoch_results(epoch, summary, prefix=f"test{i + 1}_")
        print("Finished Training")
        return None

    cli.load_eval_model(trainer, args.test_model_path)
    results = {}
    for i in range(2):
        summary = eval_split(i, with_heading=True)
        if not summary:
            continue
        results[f"test{i + 1}"] = summary
        print("---------------------------------------")
        print(f"Test {i + 1} set")
        print("mean localization error (m): ", summary["mean_distance_m"])
        print("median localization error (m): ", summary["median_distance_m"])
        print("mean orientation error (degrees): ", summary.get("mean_orientation_deg"))
        print("median orientation error (degrees): ", summary.get("median_orientation_deg"))
        for axis in ("lateral", "longitudinal"):
            print(f"{axis} recall <1/3/5 m: ",
                  [summary.get(f"{axis}_recall@{t}m") for t in (1, 3, 5)])
        print("orientation recall <1/3/5 deg: ",
              [summary.get(f"orientation_recall@{t}deg") for t in (1, 3, 5)])
    return results


if __name__ == "__main__":
    main()
