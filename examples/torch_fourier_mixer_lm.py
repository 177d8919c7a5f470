"""Beyond-paper demo on the PyTorch port: FFTB as a *layer* inside an LM
(FNet-style mixing; ``examples/fourier_mixer_lm.py`` on ``repro_torch``).

Swaps a tiny transformer's attention for
``repro_torch.core.fourier_mixer`` (Re(FFT_seq(FFT_hidden(x)))) —
demonstrating the paper's infrastructure as a composable PyTorch module in
the model stack, not just a standalone library.  Trains it on one fixed
synthetic batch (a memorization curve) and reports the losses.

    PYTHONPATH=src python examples/torch_fourier_mixer_lm.py --steps 60 \\
        [--device cpu]
"""
import argparse

import numpy as np
import torch
from torch import nn

from repro_torch.core import fourier_mixer, resolve_device
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.models.layers import MLP, mlp_apply, rms_norm, weight, zeros


class Block(nn.Module):
    """``ln1``, ``ln2`` and a GELU ``mlp`` (``w_up``, ``w_down``)."""

    def __init__(self, d, d_ff, *, gen=None, device=None):
        super().__init__()
        self.ln1 = zeros(d, device)
        self.ln2 = zeros(d, device)
        self.mlp = MLP(d, d_ff, "gelu", torch.float32, gen=gen,
                       device=device)


class FourierMixerLM(nn.Module):
    """The reference example's parameter tree: ``embed`` (tied head),
    ``layers`` and ``ln_f``."""

    def __init__(self, vocab, d, layers, d_ff, *, gen=None, device=None):
        super().__init__()
        self.embed = weight(gen, (vocab, d), scale=0.02, device=device)
        self.layers = nn.ModuleList(
            Block(d, d_ff, gen=gen, device=device) for _ in range(layers))
        self.ln_f = zeros(d, device)


def params_from_reference(tree, *, device) -> FourierMixerLM:
    """The model holding the reference example's parameters, given as
    numpy arrays in its tree (``init_params`` of
    ``examples/fourier_mixer_lm.py``)."""
    vocab, d = tree["embed"].shape
    d_ff = tree["layers"][0]["mlp"]["w_up"].shape[1]
    model = FourierMixerLM(vocab, d, len(tree["layers"]), d_ff,
                           device=device)
    pairs = [(model.embed, tree["embed"]), (model.ln_f, tree["ln_f"])]
    for blk, lp in zip(model.layers, tree["layers"]):
        pairs += [(blk.ln1, lp["ln1"]), (blk.ln2, lp["ln2"]),
                  (blk.mlp.w_up, lp["mlp"]["w_up"]),
                  (blk.mlp.w_down, lp["mlp"]["w_down"])]
    with torch.no_grad():
        for p, a in pairs:
            p.copy_(torch.tensor(np.asarray(a)))
    return model


def forward(params, tokens):
    x = params.embed[tokens]
    for lp in params.layers:
        h = rms_norm(x, lp.ln1, 1e-6)
        x = x + fourier_mixer(h)                 # FFTB spectral mixing
        h = rms_norm(x, lp.ln2, 1e-6)
        x = x + mlp_apply(lp.mlp, h, "gelu")
    h = rms_norm(x, params.ln_f, 1e-6)
    return h @ params.embed.T


def loss_fn(params, batch):
    logits = forward(params, batch["tokens"])
    lse = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, batch["labels"][..., None])[..., 0]
    return (lse - gold).mean()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    vocab, d, L, dff, B, S = 256, 64, 2, 128, 4, 32
    params = FourierMixerLM(vocab, d, L, dff,
                            gen=torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    pipe = Pipeline(DataConfig(vocab=vocab, seq=S, global_batch=B))

    losses = []
    fixed = {k: torch.as_tensor(v, device=dev).long()
             for k, v in pipe.batch_at(0).items()}
    for s in range(args.steps):
        loss = loss_fn(params, fixed)         # memorization curve
        grads = torch.autograd.grad(loss, list(params.parameters()))
        with torch.no_grad():
            for p, g in zip(params.parameters(), grads):
                p.sub_(0.05 * g)
        losses.append(float(loss.detach()))
        if s % 20 == 0:
            print(f"step {s:3d} loss {losses[-1]:.4f}")
    print(f"fourier-mixer LM: {losses[0]:.4f} -> {losses[-1]:.4f}")
    assert losses[-1] < losses[0]
    print("spectral mixing layer trains ✓ (FFTB as a model component)")
    return {"losses": losses, "params": params}


if __name__ == "__main__":
    main()
