"""Is a trained stage-2 model sensitive to its caption?

Port of the root ``probe_text_sensitivity.py``. Teacher-forced CE on
ground-truth latents under (a) the true caption, (b) the direction-swapped
caption (up<->down, left<->right: token ids 24-27 of ``MNIST_VOCAB``) and
(c) a caption shuffled from another clip. If (b) and (c) do not raise the
CE, the model ignores its text. ``--dataset single`` reads a
``cli.train_mnist_e2e`` run, ``double`` a ``cli.train_mnist2_e2e`` run: the
VQ-VAE of ``<run>/vqvae/best`` and the core of ``<run>/mage/<--ckpt>``.

The first ``--videos`` val clips at speed 0.5 are encoded once; the three
forwards share one posterior draw from a generator seeded 0 (the JAX probe
draws its own from ``PRNGKey(0)``, which torch cannot reproduce). Every
flag this parser does not know goes to the chain's parser (the run's
``--num-train``, ``--num-val``, ``--tiny``, ...). ``--device`` (default
``cuda``) is resolved before any data is built.

    python -m mage_tpu_torch.cli.probe_text_sensitivity --dataset single \\
        --run runs/mnist_e2e_full
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mage_tpu_torch.cli.probe_direction_binding import SIGN_SWAP, swap_tokens

DEFAULT_RUNS = {"single": "runs/mnist_e2e_full", "double": "runs/mnist2_e2e"}


def parse_args(argv=None):
    """-> (this CLI's arguments, the chain's arguments for the run)."""
    from mage_tpu_torch.cli import train_mnist2_e2e, train_mnist_e2e

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", choices=("single", "double"), default="double")
    p.add_argument("--run", default=None, help="default: runs/mnist_e2e_full (single), "
                                               "runs/mnist2_e2e (double)")
    p.add_argument("--ckpt", default="final")
    p.add_argument("--videos", type=int, default=16)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the kernels' plain versions")
    args, rest = p.parse_known_args(argv)
    args.run = args.run or DEFAULT_RUNS[args.dataset]
    chain = train_mnist_e2e if args.dataset == "single" else train_mnist2_e2e
    targs = chain.parse_args(["--out", args.run, "--device", args.device, *rest])
    return args, targs


@torch.no_grad()
def gt_latents(dataset: str, dev: dict, model, b: int, length: int):
    """The first ``b`` val clips at speed 0.5, every frame encoded in one
    call -> (ids (b, length, h, w) int32, speed (b,))."""
    from mage_tpu_torch.cli import train_mnist2_e2e, train_mnist_e2e
    from mage_tpu_torch.data import device_data as dd

    d = dev["val"]
    device = d["text"].device
    speed = torch.full((b,), 0.5, dtype=torch.float32, device=device)
    if dataset == "single":
        pos = dd.clip_indices(speed, frames_length=length)
        frames_at = train_mnist_e2e.frames_at
    else:
        pos = dd.clip_indices_var(speed, d["length"][:b], length)
        frames_at = train_mnist2_e2e.frames_at
    rows = torch.arange(b, device=device).repeat_interleave(length)
    ids = model.encode(frames_at(dev, "val", rows, pos.reshape(-1).long()))
    return ids.reshape(b, length, *ids.shape[1:]).to(torch.int32), speed


@torch.no_grad()
def per_frame_ce(core, ids: torch.Tensor, speed: torch.Tensor, text: torch.Tensor,
                 posterior_noise: torch.Tensor):
    """Teacher-forced eval-mode forward -> (the CE of each predicted frame
    (L-1,), averaged over clips and tokens, in f32; the argmax ids
    (B, L-1, h, w))."""
    core.eval()
    out = core(ids, text, speed, posterior_noise=posterior_noise)
    logits = out["predict"].float()  # (B, L-1, h, w, K)
    tgt = ids[:, 1:].long()
    ce = torch.logsumexp(logits, dim=-1) - logits.gather(-1, tgt[..., None])[..., 0]
    return ce.mean(dim=(0, 2, 3)), logits.argmax(dim=-1)


def probe(dataset: str, dev: dict, model, pipeline, b: int, length: int) -> dict:
    """The three captions' CE on the run's first ``b`` val clips -> the
    report (host numbers)."""
    core = pipeline.core
    device = pipeline.device
    ids, speed = gt_latents(dataset, dev, model, b, length)
    r = core.image_resolution
    noise = torch.randn((b, r, r, 64), device=device,
                        generator=torch.Generator(device=device).manual_seed(0))
    text_true = dev["val"]["text"][:b]
    variants = {"true": text_true,
                "swapped": swap_tokens(text_true, SIGN_SWAP),
                "shuffled": torch.roll(text_true, 1, dims=0)}
    ce, am = {}, {}
    for name, text in variants.items():
        c, a = per_frame_ce(core, ids, speed, text, noise)
        ce[name], am[name] = c.cpu().numpy().astype(np.float64), a
    t, s, sh = ce["true"], ce["swapped"], ce["shuffled"]
    return {
        "dataset": dataset, "videos": b,
        "direction_tokens_swapped": (variants["swapped"] != text_true).sum(dim=1).tolist(),
        "per_frame_ce": {k: v.tolist() for k, v in ce.items()},
        "mean_ce": {k: float(v.mean()) for k, v in ce.items()},
        "delta_swapped_pct": float(100 * (s.mean() / t.mean() - 1)),
        "delta_shuffled_pct": float(100 * (sh.mean() / t.mean() - 1)),
        "argmax_changed_swapped_pct": float(100 * (am["swapped"] != am["true"])
                                            .float().mean()),
        "argmax_changed_shuffled_pct": float(100 * (am["shuffled"] != am["true"])
                                             .float().mean()),
        "frames_1_4_delta_swapped_pct": float(100 * (s[:4].mean() / t[:4].mean() - 1)),
    }


def main(argv=None):
    from mage_tpu_torch.cli.eval_fvd_e2e import restore_run
    from mage_tpu_torch.data import device_data as dd
    from mage_tpu_torch.models.pipeline import resolve_device

    args, targs = parse_args(argv)
    device = resolve_device(args.device)
    build = (dd.build_compact_single_mnist if args.dataset == "single"
             else dd.build_compact_double_modified)
    dev, model, pipeline = restore_run(targs, device, args.ckpt, build)
    b = min(args.videos, int(dev["val"]["text"].shape[0]))
    rec = probe(args.dataset, dev, model, pipeline, b, targs.frames_length)
    print("direction tokens swapped per caption:", rec["direction_tokens_swapped"])
    print("\nper-frame CE (frames 1..L-1):")
    for name, values in rec["per_frame_ce"].items():
        print(f"{name:8s}:", np.array2string(np.asarray(values), precision=4))
    m = rec["mean_ce"]
    print(f"\nmean CE: true {m['true']:.5f} swapped {m['swapped']:.5f} "
          f"shuffled {m['shuffled']:.5f}")
    print(f"delta swapped-true: {rec['delta_swapped_pct']:+.1f}%, "
          f"shuffled-true: {rec['delta_shuffled_pct']:+.1f}%")
    print(f"argmax ids changed by swap: {rec['argmax_changed_swapped_pct']:.2f}% "
          f"(shuffle: {rec['argmax_changed_shuffled_pct']:.2f}%)")
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
