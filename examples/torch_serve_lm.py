"""End-to-end example of the port: continuous-batching serving of a reduced
qwen3 with batched requests, on the card (``--device cpu`` runs it on the
CPU).

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""
import sys

from repro_torch.launch.serve import main

if __name__ == "__main__":
    main(["--arch", "qwen3-14b", "--requests", "10", "--max-new", "16",
          "--max-batch", "4"] + sys.argv[1:])
