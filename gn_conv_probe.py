#!/usr/bin/env python3
"""Where the gn_conv kernel's time goes, on one GPU.

Run from the repository root with ``python3 gn_conv_probe.py``. It builds
``mage_tpu_torch/csrc/gn_conv.cu`` once per variant (one ``nvcc`` each, all
started together, into ``mage_tpu_torch/_build/probe/``) with the kernel's
probe switches (see the head of the source): ``GN_CONV_PROBE_SKIP`` drops
the activation pass (1), the weight TMA (2), the halo TMA (4) or the
``wgmma`` products (8); one variant adds ``--use_fast_math``. It times each variant's bf16 kernel alone, CUDA
events after warm-up, at the KL decoder's six shape classes in a 96-frame
chunk (``chip_smoke.GN_CONV_SITES``). The variants that drop a part compute
a wrong output: the time they save is what that part costs, and parts that
overlap save less than they cost alone. Beside them it times the wrapper's
other work: the GroupNorm statistics kernel (``gn_stats``) and its plain
version (``gn_affine_rows``), as device time (``chip_smoke.graph_ms``: the
calls replayed from a CUDA graph, since the wrapper's host work outlasts the
kernel at the small classes), and the weight packing, which the wrapper now
does once per parameter. Every variant runs twice, in alternating rounds,
so drift between rounds shows. The variants that still compute the full
result are held against the plain conv on the same affine rows.

Prints one line per (class, variant), the sums over one MAGE+ generate's
140 launches (the faster round of each class), and, last, one JSON object
with all rows. Exits 2 without a GPU.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

from chip_smoke import (BATCH, BF16_TC_FLOP_PER_S, FRAMES, GN_CONV_SITES, KL_CHUNK,
                        graph_ms, time_ms)

# name -> extra nvcc flags; "exact" variants still compute the full result
VARIANTS = {
    "base": [],
    "no_act": ["-DGN_CONV_PROBE_SKIP=1"],
    "no_wtma": ["-DGN_CONV_PROBE_SKIP=2"],
    "no_halo_tma": ["-DGN_CONV_PROBE_SKIP=4"],
    "no_wgmma": ["-DGN_CONV_PROBE_SKIP=8"],
    "only_wgmma": ["-DGN_CONV_PROBE_SKIP=7"],
    "only_act": ["-DGN_CONV_PROBE_SKIP=14"],
    "fastmath": ["--use_fast_math"],
}
EXACT = ("base", "fastmath")
ROUNDS = 2


def build_variants(build_mod) -> dict:
    """One shared library per variant, compiled in parallel."""
    out_dir = build_mod.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = build_mod.CSRC / "gn_conv.cu"
    procs = {}
    for name, flags in VARIANTS.items():
        lib = out_dir / f"gn_conv_{name}.so"
        cmd = [build_mod._nvcc(), *build_mod.NVCC_FLAGS, *flags, "-I", str(build_mod.CSRC),
               "-shared", "-o", str(lib), str(src), "-lcudart"]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).mage_gn_silu_conv3x3
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gn_conv_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from mage_tpu_torch import _build
    from mage_tpu_torch.ops import gn_conv as gc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    fns = build_variants(_build)
    stream = _build.stream_ptr(torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, per_generate = [], {}
    for (hw, c, cout), calls in GN_CONV_SITES.items():
        x = (torch.randn(KL_CHUNK, hw, hw, c, generator=gen, device="cuda") * 2
             + 0.5).to(torch.bfloat16)
        gamma = torch.randn(c, generator=gen, device="cuda") * 0.5 + 1
        beta = torch.randn(c, generator=gen, device="cuda") * 0.2
        weight = torch.randn(cout, c, 3, 3, generator=gen, device="cuda") / (9 * c) ** 0.5
        bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
        a, shift = gc.gn_stats(x, gamma, beta)
        wk, bias32 = gc._packed(weight, bias, x.dtype)
        out = torch.empty((KL_CHUNK, hw, hw, cout), dtype=x.dtype, device="cuda")
        act = torch.empty_like(x)
        want = gc.silu_conv3x3_rows(x, a, shift, weight, bias).float()
        flops = 2.0 * KL_CHUNK * hw * hw * 9 * c * cout

        def launch(name):
            err = fns[name](x.data_ptr(), a.data_ptr(), shift.data_ptr(), wk.data_ptr(),
                            bias32.data_ptr(), out.data_ptr(), act.data_ptr(), KL_CHUNK, hw,
                            hw, c, cout, _build.dtype_code(x), stream)
            if err:
                raise RuntimeError(f"variant {name}: CUDA error {err}")

        row = {"H": hw, "C": c, "Cout": cout, "calls_per_chunk": calls,
               "bound_ms": flops / BF16_TC_FLOP_PER_S * 1e3, "ms": {}, "max_abs_err": {}}
        for name in EXACT:
            launch(name)
            row["max_abs_err"][name] = float((out.float() - want).abs().max())
        for _ in range(ROUNDS):
            for name in VARIANTS:
                row["ms"].setdefault(name, []).append(time_ms(lambda: launch(name), iters=10))
            row["ms"].setdefault("wrapper", []).append(
                time_ms(lambda: gc.gn_silu_conv3x3(x, gamma, beta, weight, bias), iters=10))
            row["ms"].setdefault("stats", []).append(
                graph_ms(torch, lambda: gc.gn_stats(x, gamma, beta), iters=10))
            row["ms"].setdefault("stats_plain", []).append(
                graph_ms(torch, lambda: gc.gn_affine_rows(x, gamma, beta, 32, 1e-6), iters=5))
            row["ms"].setdefault("pack_once", []).append(time_ms(
                lambda: (weight.to(x.dtype).permute(0, 2, 3, 1).reshape(cout, 9 * c)
                         .contiguous(), bias.float().contiguous()), iters=10))
        for name, ms in row["ms"].items():
            tf = f" {flops / min(ms) * 1e-9:5.0f} TF/s" if name in VARIANTS else ""
            err = row["max_abs_err"].get(name)
            print(f"H={hw} {c}->{cout} {name:16s} " + " ".join(f"{t:.3f}" for t in ms)
                  + f" ms{tf}" + (f" err {err:.3g}" if err is not None else ""), flush=True)
        rows.append(row)
        n = calls * (BATCH * (FRAMES - 1) // KL_CHUNK)  # launches per generate
        for name, ms in [*row["ms"].items(), ("bound", [row["bound_ms"]])]:
            per_generate[name] = per_generate.get(name, 0.0) + n * min(ms)
        del x, out, want
    print("per generate (140 launches, ms): " + json.dumps(per_generate), flush=True)
    print(json.dumps({"card": smi, "gn_conv_probe": rows, "per_generate_ms": per_generate}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
