"""Serve a small model on the PyTorch port with batched requests through
the continuous-batching engine (prefill + decode slots, slot reuse on
completion; ``examples/serve_lm.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_serve_lm.py --requests 6 --slots 2 \\
        [--device cpu]
"""
import sys

from repro_torch.launch.serve import main as serve


def main(argv=None):
    reqs = serve(argv)
    assert all(r.done for r in reqs)
    print("all requests served ✓")
    return reqs


if __name__ == "__main__":
    main(sys.argv[1:])
