"""End-to-end example of the port: train the ~100M-param LM for a few
hundred steps with checkpointing and fault-tolerant supervision, on the
card (``--device cpu`` runs it on the CPU).

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--device cpu]
"""
import sys

from repro_torch.launch.train import main

if __name__ == "__main__":
    args = sys.argv[1:]
    if not any(a.startswith("--steps") for a in args):
        args += ["--steps", "300"]
    main(["--preset", "lm100m", "--batch", "8", "--seq", "256",
          "--ckpt-every", "100"] + args)
