#!/usr/bin/env python3
"""Where the fused axial block kernel's time goes, on one GPU.

Run from the repository root with ``python3 axial_block_probe.py``. It builds
``mage_tpu_torch/csrc/axial_block.cu`` once per variant (one ``nvcc`` each,
all started together, into ``mage_tpu_torch/_build/probe/``) with the
kernel's probe switch ``AXIAL_BLOCK_PROBE_SKIP`` (see the head of the
source), and times each variant's bf16 kernel alone, CUDA events after
warm-up, at the cached sampler's shape (G=512, S=16, D=512, 16 heads) and the
naive sampler's (G=8192). The bits drop the weight TMA (the ring's
barriers still turn), the ``wgmma`` products, the attention, or the ring
itself (no loads and no barrier waits: ``no_ring`` is the products and
everything around them, ``no_ring_no_wgmma`` the LayerNorms, epilogues and
attention alone). The variants that drop a part compute a wrong output: the
time they save is what that part costs. Every variant runs
twice, in alternating rounds, each time in a process of its own (a variant
that faults is reported and the others still run), so drift between rounds
shows; the base variant is held against the plain version.

Prints one line per (shape, variant) and, last, one JSON object with all
rows. Exits 2 without a GPU.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

from chip_smoke import AX_D, AX_G, AX_S, BF16_TC_FLOP_PER_S, HEADS, NAIVE_G, time_ms

# name -> extra nvcc flags
VARIANTS = {
    "base": [],
    "no_wgmma": ["-DAXIAL_BLOCK_PROBE_SKIP=1"],
    "no_weight_tma": ["-DAXIAL_BLOCK_PROBE_SKIP=2"],
    "no_attn": ["-DAXIAL_BLOCK_PROBE_SKIP=4"],
    "no_wgmma_no_tma": ["-DAXIAL_BLOCK_PROBE_SKIP=3"],
    "no_ring": ["-DAXIAL_BLOCK_PROBE_SKIP=16"],
    "no_ring_no_wgmma": ["-DAXIAL_BLOCK_PROBE_SKIP=17"],
}
ROUNDS = 2


def build_variants(build_mod) -> dict:
    """One shared library per variant, compiled in parallel: name -> path."""
    out_dir = build_mod.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = build_mod.CSRC / "axial_block.cu"
    procs = {}
    for name, flags in VARIANTS.items():
        lib = out_dir / f"axial_block_{name}.so"
        cmd = [build_mod._nvcc(), *build_mod.NVCC_FLAGS, *flags, "-I", str(build_mod.CSRC),
               "-shared", "-o", str(lib), str(src), "-lcudart"]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
    return {name: lib for name, (lib, _) in procs.items()}


def time_variant(name: str, lib: str) -> int:
    """In a process of its own (a variant that faults leaves the others'
    numbers standing): time one variant at both shapes, print one JSON line
    each; the base variant is also held against the plain version."""
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from mage_tpu_torch import _build
    from mage_tpu_torch.models import layers as tl
    from mage_tpu_torch.ops import axial_attention as ax

    from chip_smoke import block_weights

    fn = ctypes.CDLL(lib).mage_axial_block
    fn.argtypes = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = _build.stream_ptr(torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = block_weights(torch, tl, gen, torch.bfloat16).fused_block_params()
    hd = AX_D // HEADS
    for g in (AX_G, NAIVE_G):
        x = torch.randn(g, AX_S, AX_D, generator=gen, device="cuda").to(torch.bfloat16)
        out = torch.empty_like(x)

        def launch():
            err = fn(x.data_ptr(), *(p.data_ptr() for p in params), out.data_ptr(), g, AX_S,
                     AX_D, HEADS, _build.dtype_code(x), 1.0 / hd ** 0.5, 1e-5, stream)
            if err:
                raise RuntimeError(f"variant {name}: CUDA error {err}")

        row = {"name": name, "G": g, "ms": time_ms(launch, iters=10 if g == AX_G else 3)}
        if name == "base":
            with torch.no_grad():
                want = ax.axial_block_fused(x, params, HEADS, impl="torch")
            row["max_abs_err"] = float((out.float() - want.float()).abs().max())
        print(json.dumps(row), flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("axial_block_probe: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) == 3:
        return time_variant(sys.argv[1], sys.argv[2])
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from mage_tpu_torch import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build_variants(_build)
    ms: dict = {}
    err = {}
    for _ in range(ROUNDS):
        for name, lib in libs.items():
            res = subprocess.run([sys.executable, __file__, name, str(lib)],
                                 capture_output=True, text=True, timeout=300)
            got = [json.loads(line) for line in res.stdout.splitlines() if line.startswith("{")]
            for row in got:
                ms.setdefault((row["G"], name), []).append(row["ms"])
                if "max_abs_err" in row:
                    err[row["G"]] = row["max_abs_err"]
            if res.returncode != 0:
                print(f"variant {name} failed: {res.stderr.strip()[-500:]}", flush=True)
    rows = []
    for g in (AX_G, NAIVE_G):
        flops = 2.0 * g * AX_S * 12 * AX_D * AX_D + 4.0 * g * AX_S * AX_S * AX_D
        row = {"G": g, "S": AX_S, "D": AX_D, "heads": HEADS,
               "bound_ms": flops / BF16_TC_FLOP_PER_S * 1e3,
               "base_max_abs_err": err.get(g), "ms": {}}
        for name in libs:
            times = ms.get((g, name), [])
            row["ms"][name] = times
            rate = f" {flops / min(times) * 1e-9:6.1f} TF/s" if times else " failed"
            print(f"G={g} {name:16s} " + " ".join(f"{t:.4f}" for t in times) + " ms" + rate,
                  flush=True)
        rows.append(row)
    print(json.dumps({"card": smi, "axial_block_probe": rows}), flush=True)
    return 0 if all(len(t) == ROUNDS for t in ms.values()) and len(ms) == 2 * len(libs) else 1


if __name__ == "__main__":
    sys.exit(main())
