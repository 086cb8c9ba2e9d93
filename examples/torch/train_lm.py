"""End-to-end driver on the PyTorch/CUDA port: train a (reduced) assigned
architecture for a few hundred steps with checkpointing + fault
tolerance, then print the DVFS clock plan for the step.

It exercises the data pipeline, model, optimizer, checkpoint manager and
the paper's technique in one run.  Checkpoints go under the temporary
directory (``$TMPDIR``).

Run:  PYTHONPATH=src python examples/torch/train_lm.py [--arch qwen2-0.5b]
      [--steps 200] [--device cpu]
"""
import argparse
import os
import tempfile

from repro_torch.launch import train as train_launch


def main(argv=None) -> list:
    """Train; return the driver's metrics rows (``loss``, ``step``, ...)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    log: list = []
    train_launch.main([
        "--arch", args.arch, "--reduced",
        "--steps", str(args.steps),
        "--batch", "8", "--seq", "128",
        "--lr", "3e-3",
        "--ckpt-dir", os.path.join(tempfile.gettempdir(),
                                   "repro_torch_example_ckpt"),
        "--dvfs-report", "--device", args.device,
    ], log=log)
    return log


if __name__ == "__main__":
    main()
