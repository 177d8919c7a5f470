"""Train an LM end-to-end on the PyTorch port with the full production
stack: deterministic data pipeline, AdamW, remat, checkpointing,
auto-resume (``examples/train_lm.py`` on ``repro_torch``).

Presets:
  cpu-ci  reduced model, a few hundred steps in minutes on CPU (default)
  100m    ~100M-param model (same family), the launcher's larger preset;
          run it on the card, it is far too slow for 1 CPU core

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200 [--device cpu]
    PYTHONPATH=src python examples/torch_train_lm.py --arch mamba2-370m --steps 50

Runs resume from the newest checkpoint in ``--ckpt-dir``: give a fresh
directory for a fresh curve.
"""
import sys

from repro_torch.launch.train import main as train


def main(argv=None):
    args = list(argv or [])
    if not any(a.startswith("--steps") for a in args):
        args += ["--steps", "200"]
    if "--fixed-batch" not in args:
        args += ["--fixed-batch"]     # memorization curve: CI-stable signal
    trainer = train(args)
    losses = [h["loss"] for h in trainer.history]
    if len(losses) >= 20:
        first = sum(losses[:10]) / 10
        last = sum(losses[-10:]) / 10
        print(f"mean(first 10)={first:.4f}  mean(last 10)={last:.4f}")
        assert last < first, "training must reduce loss"
        print("loss decreased ✓")
    return losses


if __name__ == "__main__":
    main(sys.argv[1:])
