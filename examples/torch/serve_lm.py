"""Serve a (reduced) assigned architecture with batched requests on the
PyTorch/CUDA port: prefill + greedy decode, plus the per-phase DVFS clock
plan showing the paper's headline — decode is memory-bound, so the clock
drops ~40% nearly for free while prefill stays near boost.

Run:  PYTHONPATH=src python examples/torch/serve_lm.py [--arch qwen2-0.5b]
      [--device cpu]
"""
import argparse

from repro_torch.launch import serve as serve_launch


def main(argv=None):
    """Serve; return the generated tokens."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return serve_launch.main([
        "--arch", args.arch, "--reduced",
        "--batch", "4", "--prompt-len", "32", "--gen", "16",
        "--dvfs-report", "--device", args.device,
    ])


if __name__ == "__main__":
    main()
