"""Qualitative visualization of one test sample of VIGOR, KITTI or Oxford
RobotCar (counterpart of ``ccvpe_tpu/visualize.py``): the log-scaled
heatmap over the aerial image with the GT and predicted positions, and the
orientation field as a quiver plot.

    python -m ccvpe_torch.visualize --dataset KITTI --dataset_root ... --idx 3
    CCVPE_PLATFORM=cpu python -m ccvpe_torch.visualize --dataset VIGOR \\
        --dataset_root ... --model_preset NANO --matching_impl plain

It runs on the CUDA device (through the matching kernels, ``--matching_impl
kernel``) unless ``CCVPE_PLATFORM=cpu``; without CUDA and without that
switch it raises.  The flags of the root
``visualize_qualitative_results_VIGOR.py`` all work with ``--dataset
VIGOR``.  ``predict_sample`` is everything before the drawing: the sample,
the eval forward and the arrays ``render`` draws.

``--test_model_path`` loads a reference-format ``.pt`` (``api.load_model``);
without one the model takes the port's seeded init (seed 0), which is not
the JAX package's ``PRNGKey(0)`` draw, so the two packages' random-weight
pictures differ.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def render(sat_img, heatmap, ori, gt, out_path: str, quiver_step: int = 40):
    """Two-panel figure of ``heatmap`` [H, W] over ``sat_img`` with the GT
    (``gt`` [H, W]) and predicted peaks, and the (cos, sin) field ``ori``
    [H, W, 2] as a quiver; returns ``(loc_pred, loc_gt)``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import LogNorm

    loc_gt = np.unravel_index(gt.argmax(), gt.shape)
    loc_pred = np.unravel_index(heatmap.argmax(), heatmap.shape)

    fig, axes = plt.subplots(1, 2, figsize=(14, 7))
    axes[0].imshow(sat_img)
    axes[0].imshow(heatmap, norm=LogNorm(vmax=heatmap.max()), alpha=0.6, cmap="Reds")
    axes[0].scatter(loc_gt[1], loc_gt[0], s=200, marker="^", c="g",
                    edgecolors="white", label="GT")
    axes[0].scatter(loc_pred[1], loc_pred[0], s=200, marker="*", c="gold",
                    edgecolors="white", label="Pred")
    axes[0].legend()
    axes[0].set_title("localization heatmap")
    axes[0].axis("off")

    ys, xs = np.mgrid[0:heatmap.shape[0]:quiver_step, 0:heatmap.shape[1]:quiver_step]
    axes[1].imshow(sat_img)
    axes[1].quiver(xs, ys, ori[::quiver_step, ::quiver_step, 1],
                   ori[::quiver_step, ::quiver_step, 0], color="r")
    axes[1].set_title("orientation field (cos/sin)")
    axes[1].axis("off")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return loc_pred, loc_gt


def load_sample(dataset: str, args, cfg, device=None):
    """One test sample (the collated host batch) and its device batch on
    ``device`` (default ``cuda``)."""
    from .data import kitti, oxford, vigor
    from .data.pipeline import collate

    if dataset == "VIGOR":
        # the reference's rounding, and the frozen-fixture contract: an
        # unknown orientation comes from the shipped .npy, never a fresh draw
        ori_noise = 18 * (args.ori_noise // 18)
        random_orientation = None
        if ori_noise >= 180:
            base = f"{args.area}_orientation_test.npy"
            shipped = os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                "fixtures", base)
            candidates = ([os.path.join(args.orientation_dir, base)]
                          if args.orientation_dir not in ("", ".")
                          else [shipped, base])
            fname = next((c for c in candidates if os.path.exists(c)), None)
            if fname is None:
                raise SystemExit(
                    f"frozen orientation fixture {base} not found in "
                    f"{candidates}; pass --orientation_dir (or --ori_noise "
                    "< 180 for a known-orientation prior)")
            random_orientation = np.load(fname)
        index = vigor.VigorIndex.load(args.dataset_root, args.area, False)
        sampler = vigor.VigorSampler(
            index, pos_only=args.pos_only == "True", ori_noise=ori_noise,
            random_orientation=random_orientation, grd_hw=cfg.grd_hw, sat_hw=cfg.sat_hw)
        raw = collate([sampler(args.idx)])
        batch = vigor.device_batch(raw, train=False, sat_hw=cfg.sat_hw, bins=cfg.bins,
                                   device=device)
    elif dataset == "KITTI":
        index = kitti.KittiIndex.load(
            args.dataset_root, os.path.join(args.dataset_root, args.test_file), test=True)
        sampler = kitti.KittiSampler(index, rotation_range=args.rotation_range,
                                     grd_hw=cfg.grd_hw, sat_hw=cfg.sat_hw)
        raw = collate([sampler(args.idx)])
        batch = kitti.device_batch(raw, train=False, sat_hw=cfg.sat_hw, bins=cfg.bins,
                                   device=device)
    elif dataset == "OxfordRobotCar":
        sat_path = args.sat_path or os.path.join(args.dataset_root, "satellite_map_new.png")
        index = oxford.OxfordIndex.load(args.dataset_root, sat_path, "test")
        sampler = oxford.OxfordSampler(index, grd_hw=cfg.grd_hw, sat_hw=cfg.sat_hw)
        raw = collate([sampler(args.idx)])
        batch = oxford.device_batch(raw, train=False, sat_hw=cfg.sat_hw, bins=cfg.bins,
                                    device=device)
    else:
        raise SystemExit(f"unknown dataset {dataset!r}")
    return raw, batch


def predict_sample(dataset: str, args, cfg, net, device):
    """The sample's eval forward (``net`` on ``device``, at
    ``args.matching_impl``): ``(sat_img [H, W, 3] uint8, heatmap [H, W],
    ori [H, W, 2], gt [H, W])`` as numpy arrays, what ``render`` draws.
    A VIGOR ``--ori_noise`` under 180 restricts the localization to the
    prior's bins ``range(-n, n + 1)``, n from the unrounded value."""
    from .train import loop as train_loop

    raw, batch = load_sample(dataset, args, cfg, device)
    loc_offsets = None
    if dataset == "VIGOR" and args.ori_noise < 180:
        n = int((18 * (args.ori_noise // 18)) / 18)
        loc_offsets = tuple(range(-n, n + 1))
    step = train_loop.make_eval_step(cfg, loc_offsets=loc_offsets,
                                     matching_impl=args.matching_impl)
    out = step(net, batch["grd"], batch["sat"])
    return (raw["sat"][0], out.heatmap[0, :, :, 0].cpu().numpy(), out.ori[0].cpu().numpy(),
            batch["gt"][0].cpu().numpy())


def run(dataset: str, args) -> str:
    from . import api
    from .models import cvm
    from .utils.platform import env_device

    device = env_device()
    preset = args.model_preset or dataset
    cfg = cvm.PRESETS[preset]
    checkpoint = None
    if args.test_model_path and os.path.exists(args.test_model_path):
        checkpoint = args.test_model_path
    else:
        print(f"checkpoint {args.test_model_path!r} not found; using random weights")
    net = api.load_model(checkpoint, preset=preset, device=device).net
    sat_img, heatmap, ori, gt = predict_sample(dataset, args, cfg, net, device)
    pred, gt_loc = render(sat_img, heatmap, ori, gt, args.out)
    print(f"saved {args.out}; pred={pred} gt={gt_loc}")
    return args.out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="qualitative pose visualization")
    p.add_argument("--dataset", default="VIGOR", choices=["VIGOR", "KITTI", "OxfordRobotCar"])
    p.add_argument("--idx", type=int, default=0)
    p.add_argument("--dataset_root", type=str, default="datasets/VIGOR")
    p.add_argument("--test_model_path", type=str, default="")
    p.add_argument("--model_preset", type=str, default="")
    p.add_argument("--out", type=str, default="qualitative_result.png")
    p.add_argument("--matching_impl", choices=("kernel", "plain"), default="kernel",
                   help="the CUDA matching kernels (on the card) or their plain versions")
    # VIGOR
    p.add_argument("--area", type=str, default="samearea")
    p.add_argument("--pos_only", choices=("True", "False"), default="True")
    p.add_argument("--ori_noise", type=float, default=180.0)
    p.add_argument("--orientation_dir", type=str, default=".")
    # KITTI (the KITTI-CVL release ships test1/test2 splits)
    p.add_argument("--test_file", type=str, default="test1_files.txt")
    p.add_argument("--rotation_range", type=float, default=10.0)
    # Oxford
    p.add_argument("--sat_path", type=str, default="")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    return run(args.dataset, args)


if __name__ == "__main__":
    main()
