"""What the three train/eval CLIs of the port share
(``ccvpe_torch.train_VIGOR``, ``train_KITTI``, ``train_OxfordRobotCar``;
counterparts of the root ``train_*.py`` of the JAX package): the framework
flags, the device, the ``Trainer`` built from the flags, the model of an
eval run, the epoch orders of a training run, and ``run_main``, which
joins the process group of a ``torchrun`` launch before a CLI's body and
meets the other ranks at ``finalize_run`` after it:

    torchrun --nproc_per_node 8 -m ccvpe_torch.train_VIGOR --dataset_root ... -b 64
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..parallel import mesh
from .harness import Trainer


def add_common_flags(p: argparse.ArgumentParser, *, test_model_path: str,
                     epochs: int, cache_help: str) -> None:
    """The flags the three CLIs share, with the JAX CLIs' names and defaults."""
    p.add_argument("--training", choices=("True", "False"), default="True")
    p.add_argument("-l", "--learning_rate", type=float, default=1e-4)
    p.add_argument("-b", "--batch_size", type=int, default=8)
    p.add_argument("--weight_ori", type=float, default=1e1)
    p.add_argument("--weight_infoNCE", type=float, default=1e4)
    p.add_argument("--epochs", type=int, default=epochs)
    p.add_argument("--steps_per_epoch", type=int, default=0,
                   help="limit steps per epoch (0 = full epoch)")
    p.add_argument("--checkpoint_dir", type=str, default="")
    p.add_argument("--results_dir", type=str, default="results")
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler Chrome trace of train steps 10-13 "
                        "(or the first steps of short epochs) to this directory")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--native_loader", action="store_true",
                   help="decode whole batches in the C++ thread pool "
                        "(also enabled by CCVPE_NATIVE_LOADER=1)")
    p.add_argument("--fast_decode", action="store_true",
                   help="DCT-scaled JPEG decode for the training feed "
                        "(native loader only; not bit-identical to PIL, "
                        "never used for eval; also CCVPE_FAST_DECODE=1)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--init_model_path", type=str, default="",
                   help="warm-start training from a reference-format .pt "
                        "checkpoint (fine-tuning); unlike --resume, optimizer "
                        "state starts fresh")
    p.add_argument("--test_model_path", type=str, default=test_model_path,
                   help="reference-format .pt to evaluate; any other path "
                        "evaluates the latest checkpoint of --checkpoint_dir, "
                        "else seeded random weights")
    p.add_argument("--cache_dir", type=str, default="", help=cache_help)
    p.add_argument("--grad_accum", type=int, default=1,
                   help="accumulate gradients over N strided microbatches "
                        "inside the step (activation peak = one microbatch)")
    p.add_argument("--keep_checkpoints", type=int, default=3,
                   help="retained checkpoints (0 = keep every step, the "
                        "reference's keep-all-epochs behavior)")
    p.add_argument("--checkpoint_every_steps", type=int, default=0,
                   help="also checkpoint mid-epoch every N steps "
                        "(preemption recovery; 0 = per-epoch only)")
    p.add_argument("--matching_impl", default="kernel", choices=("kernel", "plain"),
                   help="orientation matching: the CUDA kernels (on a CUDA "
                        "device) or their plain PyTorch versions")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1: shard the optimizer state (Adam moments, the f32 "
                        "master) over the data-parallel ranks")
    p.add_argument("--n_model", type=int, default=1,
                   help="ranks per model replica: shard large weights and their "
                        "optimizer state over them (FSDP2); must divide the world size")
    p.add_argument("--bf16", action="store_true",
                   help="train in bfloat16 (inputs and activations; the loss in float32)")
    p.add_argument("--bf16_params", action="store_true",
                   help="bfloat16-resident parameters with a float32 master in the "
                        "optimizer state")
    p.add_argument("--pretrained_b0", type=str, default="",
                   help="initialize both encoders from a raw EfficientNet-B0 state_dict: "
                        "a local path, or 'auto'/'efficientnet-bN' through the verified "
                        "download cache")
    p.add_argument("--remat", nargs="?", const="all", default="",
                   choices=("all", "encoder", "decoder"),
                   help="recompute activations in the backward: 'all' (the default "
                        "when given bare), only the encoders, or only the decoder stages")


def run_main(body, argv=None):
    """A CLI's ``main``: join the process group that ``torchrun`` sets up
    (``parallel.mesh.maybe_init_distributed``; a no-op otherwise), run
    ``body(argv)``, then meet every rank at ``finalize_run``."""
    mesh.maybe_init_distributed()
    ret = body(argv)
    mesh.finalize_run()
    return ret


def make_trainer(cfg, args, *, label: str, checkpoint_dir: str, device) -> Trainer:
    return Trainer(
        cfg, learning_rate=args.learning_rate, weight_info_nce=args.weight_infoNCE,
        weight_ori=args.weight_ori, checkpoint_dir=args.checkpoint_dir or checkpoint_dir,
        results_dir=args.results_dir, label=label, batch_size=args.batch_size,
        checkpoint_every_steps=args.checkpoint_every_steps,
        keep_checkpoints=args.keep_checkpoints, profile_dir=args.profile_dir or None,
        grad_accum=args.grad_accum, matching_impl=args.matching_impl, device=device,
        zero1=args.zero1, n_model=args.n_model,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        param_dtype="bfloat16" if args.bf16_params else "float32",
        remat=args.remat or False)


def start_training(trainer: Trainer, args) -> None:
    """Resume with ``--resume`` when a checkpoint is there; else warm-start
    from ``--init_model_path``, or start from seeded weights (both encoders
    from ``--pretrained_b0`` when given)."""
    if args.resume and trainer.resume():
        return
    if args.init_model_path:
        trainer.load_torch_checkpoint(args.init_model_path)
    else:
        trainer.init_state(pretrained_b0=args.pretrained_b0 or None)


def load_eval_model(trainer: Trainer, path: str) -> None:
    """An existing ``.pt`` is evaluated; otherwise the latest checkpoint of
    the trainer's directory, else seeded random weights -- said on stdout."""
    if path.endswith(".pt") and os.path.exists(path):
        trainer.load_torch_checkpoint(path)
        return
    trainer.init_state()
    if trainer.resume():
        print(f"--test_model_path {path!r} is not a .pt file: evaluating the "
              f"checkpoint of step {trainer.state.step}")
    else:
        print(f"--test_model_path {path!r} not found and no checkpoint: "
              "evaluating seeded random weights")


def epoch_orders(trainer: Trainer, indices: np.ndarray, epochs: int):
    """(epoch, shuffled order) from ``trainer.start_epoch`` on, from
    ``np.random.default_rng(0)``; the completed epochs' shuffles are burned
    first, so epoch k's order is an uninterrupted run's."""
    rng = np.random.default_rng(0)
    if trainer.start_epoch:
        print(f"resuming at epoch {trainer.start_epoch}")
        for _ in range(trainer.start_epoch):
            rng.shuffle(indices.copy())
    for epoch in range(trainer.start_epoch, epochs):
        order = indices.copy()
        rng.shuffle(order)
        yield epoch, order


def limit(idx: np.ndarray, args) -> np.ndarray:
    """The first ``--steps_per_epoch`` batches' worth of ``idx``."""
    return idx[:args.steps_per_epoch * args.batch_size] if args.steps_per_epoch else idx
