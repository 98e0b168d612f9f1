"""The counts under ``benchmark/counts`` against ``FlopCounterMode`` over the
plain reference and plain ops at small shapes, and their bytes against the
tensors' own sizes; each kernel's work reckoned from a configuration
against the launches that one call or step of the program makes; and the
roofline reader over a trace."""

import json
import math

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness, readers
from benchmark.counts import flops, kernels
from benchmark.counts.peaks import least_seconds
from benchmark.reference.train import run_steps
from benchmark.reference.model import Reference
from benchmark.tests import launches
from benchmark.tests.small import CONFIGS, small_mix

SEED = 987654321012


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_generate_flops_match_the_reference(small_config):
    p = json.loads((CONFIGS / f"{small_config}.json").read_text())["model"]["params"]
    shapes = _shapes(small_config)
    ref = Reference(harness.make_weights(shapes, 3, torch.float32, "cpu"), p)
    b, length, r = 2, p["frames_length"], p["image_resolution"]
    fs = p["first_stage_config"]["params"]
    res = r * fs["down_ratio"] if p["use_cids"] else fs["ddconfig"]["resolution"]
    g = torch.Generator().manual_seed(0)
    frames0 = torch.rand(b, res, res, 3, generator=g) - 0.5
    text = torch.zeros(b, p["text_encoder_config"]["params"]["context_length"], dtype=torch.long)
    text[:, :6] = torch.tensor([1, 3, 4, 5, 6, 2])
    speed = torch.rand(b, generator=g)
    noise = torch.randn(b, r, r, 64, generator=g)

    def whole():
        if p["use_cids"]:
            first = ref.vq_distances(ref.vq_latents(frames0)).argmin(-1)[:, None]
            fed = torch.cat([first] * (length - 1), dim=1)
        else:
            z = p["first_stage_config"]["params"]["embed_dim"]
            first = ref.kl_sample(frames0, torch.randn(b, r, r, z, generator=g))[:, None]
            fed = torch.cat([first] * (length - 1), dim=1)
        stem = ref.stem(ref.embed(fed))
        trunk = ref.trunk(ref.prepare(stem[:, 0], text, speed, noise), stem)
        out = ref.logits(trunk).argmax(-1) if p["use_cids"] else ref.causal_head(trunk)
        (ref.vq_decode if p["use_cids"] else ref.kl_decode)(out.flatten(0, 1))

    assert counted(whole) == pytest.approx(flops.generate(p, b, temporal="full"), rel=1e-12)


def test_cached_sampler_attends_over_the_slots_so_far():
    p = json.loads((CONFIGS / "tiny_mage.json").read_text())["model"]["params"]
    full, cached = flops.generate(p, 3, "full"), flops.generate(p, 3, "cached")
    length, tok, c = p["frames_length"], p["image_resolution"] ** 2, p["vision_width"]
    n_t = len(range(0, p["generate_decoder_config"]["params"]["layers"], 3))
    pairs_saved = length * length - length * (length + 1) / 2
    assert full - cached == pytest.approx(3 * n_t * tok * 4.0 * c * pairs_saved)


def _shapes(config):
    from mage_tpu_torch.models.pipeline import build_pipeline

    pipe = build_pipeline(CONFIGS / f"{config}.json", device="cpu")
    return {k: tuple(v.shape) for k, v in pipe.state_dict().items()}


def _bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_counts(dtype):
    g, s, d, h = 6, 5, 32, 2
    q, k, v = (torch.randn(g, s, d).to(dtype) for _ in range(3))

    def plain():
        qh, kh, vh = (t.float().reshape(g, s, h, d // h).transpose(1, 2) for t in (q, k, v))
        return (torch.softmax(qh @ kh.transpose(-1, -2), -1) @ vh).transpose(1, 2)

    nbytes, ops, _ = kernels.load("axial").count(g, s, d, h, q.element_size())
    assert ops == counted(plain)
    assert nbytes == _bytes(q, k, v, q)

    n, length, pos = 7, 6, 3
    qn = torch.randn(n, d).to(dtype)
    ck, cv = (torch.randn(length, n, d).to(dtype) for _ in range(2))

    def plain_cached():
        kk, vv = (c[:pos + 1].float().permute(1, 0, 2).reshape(n, pos + 1, h, d // h)
                  .transpose(1, 2) for c in (ck, cv))
        qq = qn.float().reshape(n, 1, h, d // h).transpose(1, 2)
        return torch.softmax(qq @ kk.transpose(-1, -2), -1) @ vv

    nbytes, ops, _ = kernels.load("cached").count(n, length, d, pos, qn.element_size())
    assert ops == counted(plain_cached)
    assert nbytes == _bytes(qn, qn, ck[:pos + 1], cv[:pos + 1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_stats_and_vq_counts(dtype):
    b, h, w, c, cout = 2, 6, 5, 32, 16
    x = torch.randn(b, h, w, c).to(dtype)
    weight = torch.randn(cout, c, 3, 3).to(dtype)
    nbytes, ops, _ = kernels.load("gn_conv").count(b, h, w, c, cout, x.element_size())
    out = torch.empty(b, h, w, cout, dtype=dtype)
    rows = torch.empty(2, b, c)
    bias = torch.empty(cout)
    assert ops == counted(lambda: F.conv2d(x.float().permute(0, 3, 1, 2), weight.float(),
                                           padding=1))
    assert nbytes == _bytes(x, weight, out, rows, bias)
    nbytes, ops, _ = kernels.load("gn_stats").count(b, h, w, c, x.element_size())
    assert nbytes == _bytes(x, torch.empty(2, c), rows)
    assert ops == 3 * x.numel()

    n, k, d = 10, 12, 16
    z, cb = torch.randn(n, d).to(dtype), torch.randn(k, d).to(dtype)
    for with_codes in (False, True):
        nbytes, ops, _ = kernels.load("vq").count(n, k, d, z.element_size(), with_codes)
        assert ops == counted(lambda: z.float() @ cb.float().T)
        outs = [torch.empty(n, dtype=torch.int32)] + ([z] if with_codes else [])
        assert nbytes == _bytes(z, cb, *outs)
    assert math.isclose(kernels.load("vq").count(n, k, d, 2, False)[2], 989e12)


def test_train_step_flops_match_the_reference():
    """One step of the reference's training (the frozen encode, stage 2's
    forward and backward) counts what ``flops.train_step`` says."""
    p = json.loads((CONFIGS / "tiny_mage.json").read_text())["model"]["params"]
    weights = harness.make_weights(_shapes("tiny_mage"), 3, torch.float32, "cpu")
    b, length, r = 2, p["frames_length"], p["image_resolution"]
    res = r * p["first_stage_config"]["params"]["down_ratio"]
    g = torch.Generator().manual_seed(0)
    text = torch.zeros(b, p["text_encoder_config"]["params"]["context_length"], dtype=torch.long)
    text[:, :6] = torch.tensor([1, 3, 4, 5, 6, 2])
    step = {"frames": torch.rand(b, length, res, res, 3, generator=g) - 0.5, "text": text,
            "speed": torch.rand(b, generator=g), "posterior_noise": torch.randn(b, r, r, 64),
            "ids": torch.randint(0, p["codebook_size"], (b, length, r, r), generator=g),
            "masks": {}}
    hyper = {"lr": 1e-4, "beta": 0.1, "alpha": 0.1, "betas": (0.9, 0.98), "eps": 1e-6}
    p0 = dict(p, dropout=0.0)
    p0["text_encoder_config"] = {"params": dict(p["text_encoder_config"]["params"], dropout=0.0)}
    assert counted(lambda: run_steps(weights, p0, [step], hyper)) == pytest.approx(
        flops.train_step(p, b), rel=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vq_decode_tail_counts(dtype):
    from mage_tpu_torch.ops.vq_tail import _vq_tail_plain

    b, h, w, c, cout, o = 2, 6, 4, 16, 32, 3
    g = torch.Generator().manual_seed(0)
    args = (torch.randn(b, h, w, c, generator=g).to(dtype),
            torch.randn(b, h // 2, w // 2, cout, generator=g).to(dtype),
            torch.randn(cout, c, 3, 3, generator=g).to(dtype), torch.randn(cout),
            torch.randn(o, cout, 1, 1, generator=g).to(dtype), torch.randn(o).to(dtype))
    nbytes, ops, peak = kernels.load("vq_decode_tail").count(b, h, w, c, cout, o,
                                                             args[0].element_size())
    out = _vq_tail_plain(*args)
    assert ops == counted(lambda: _vq_tail_plain(*args))
    assert nbytes == _bytes(*args, out)
    assert peak == 989e12


def test_vq_decode_tail_bound_at_the_mage_cell():
    """A MAGE generate at batch 32, L = 10: 288 frames at 128 px, 1.399
    TFLOP and 1.237 GB, bound by the operations at 1.414 ms."""
    p = harness.read_json(harness.HERE / "configs" / "mage_caterv1.json")["model"]["params"]
    mix = harness.read_json(harness.HERE / "traffic" / "gen_b32.json")
    (piece,) = kernels.load("vq_decode_tail").pieces(p, mix, 2)
    assert round(piece[1] / 1e12, 3) == 1.399 and round(piece[0] / 1e9, 3) == 1.237
    assert least_seconds(*piece) == (pytest.approx(1.414e-3, abs=5e-7), "operations")


def test_every_kernel_file_has_its_names_counts_work_and_reader():
    readers_of = {p.stem.split("_roofline")[0] for p in (harness.HERE / "metrics").glob("*.py")
                  if "_roofline" in p.stem}
    assert readers_of == set(kernels.names())
    for name in kernels.names():
        spec = kernels.load(name)
        assert spec.TRACE_NAMES and isinstance(spec.TRACE_NAMES, tuple)
        assert callable(spec.count) and callable(spec.pieces)


GENERATE_MIXES = {
    "cached": {},
    "naive": {"cached": False},
    "fusedblock": {"spatial_attn": "fusedblock"},
    "kv_int8": {"kv_quant": "int8"},
}


@pytest.mark.parametrize("route", sorted(GENERATE_MIXES))
def test_reckoned_work_equals_the_launches_of_a_mage_generate(route, monkeypatch):
    """One generate of the small MAGE on each route, its VQ decode's tail
    sent down the fused route (the kernel takes only the published widths
    on the card; the entry point runs its plain version here)."""
    from mage_tpu_torch.models import vqvae
    from mage_tpu_torch.ops import vq_tail

    monkeypatch.setattr(vqvae, "_on_card", lambda x: True)
    monkeypatch.setattr(vq_tail, "kernel_takes", lambda *widths: True)
    mix = {**small_mix(), **GENERATE_MIXES[route]}
    p, itemsize, shapes = launches.one_generate(CONFIGS / "tiny_mage.json", mix, "cpu", SEED)
    got = launches.held(p, mix, itemsize, shapes)
    want = {"cached": {"axial", "cached", "vq", "vq_decode_tail"},
            "naive": {"axial", "vq", "vq_decode_tail"},
            "fusedblock": {"cached", "vq", "vq_decode_tail"},
            "kv_int8": {"axial", "vq", "vq_decode_tail"}}[route]
    assert set(got) == want


@pytest.mark.parametrize("chunk", [None, 2])
def test_reckoned_work_equals_the_launches_of_a_mageplus_generate(chunk, monkeypatch):
    """One generate of the small MAGE+, its KL decode in one chunk and, with
    ``chunk``, in chunks of that many frames: each chunk's launches read
    the weights and the affine rows again."""
    from mage_tpu_torch.models import pipeline

    if chunk:
        monkeypatch.setattr(pipeline, "KL_FRAME_CHUNK", chunk)
    mix = small_mix()
    p, itemsize, shapes = launches.one_generate(CONFIGS / "tiny_mageplus.json", mix, "cpu",
                                                SEED)
    got = launches.held(p, mix, itemsize, shapes)
    assert set(got) == {"axial", "cached", "gn_conv", "gn_stats"}
    frames = mix["batch"] * (p["frames_length"] - 1)
    chunks = frames // chunk if chunk else 1
    assert {s[0] for k, s in shapes if k == "gn_conv"} == {frames // chunks}
    for name in ("gn_conv", "gn_stats"):
        reckoned, launched = got[name]["bytes"]
        assert (launched > reckoned) == (chunks > 1)


def test_reckoned_work_equals_the_launches_of_a_train_step():
    mix = small_mix(train=True)
    p, itemsize, shapes = launches.one_train_step(CONFIGS / "tiny_mage.json", mix, "cpu", SEED)
    assert set(launches.held(p, mix, itemsize, shapes)) == {"vq"}


def test_roofline_reads_the_reckoned_work_over_the_kernels_device_time():
    """No launch record: the cell's pieces times the profiled calls, over
    the device time of the events under the kernel's trace names, whatever
    their namespace or template arguments; None where the route runs no
    such kernel or the trace shows none."""
    p = harness.read_json(harness.HERE / "configs" / "mage_caterv1.json")["model"]["params"]
    mix = harness.read_json(harness.HERE / "traffic" / "gen_b32.json")
    events = [("void (anonymous namespace)::cached_attention<bf16>(float*)", 1.0, 1.004),
              ("cached_attention", 2.0, 2.002), ("vq_tail_bf16", 3.0, 3.01),
              ("other", 4.0, 5.0)]
    rec = {"kind": "generate", "model": p, "mix": mix, "itemsize": 2, "profiled_calls": 3,
           "trace": {"device_events": events}}
    least = 3 * sum(least_seconds(*x)[0] for x in kernels.load("cached").pieces(p, mix, 2))
    assert readers.roofline_pct(rec, "cached") == pytest.approx(100 * least / 0.006)
    tail = 3 * least_seconds(*kernels.load("vq_decode_tail").pieces(p, mix, 2)[0])[0]
    assert readers.roofline_pct(rec, "vq_decode_tail") == pytest.approx(100 * tail / 0.01)
    assert readers.roofline_pct(rec, "axial") is None  # no device event
    assert readers.roofline_pct(rec, "gn_conv") is None  # MAGE runs no KL decode
    assert readers.roofline_pct({**rec, "trace": None}, "cached") is None
    train = {"kind": "train", "model": p, "mix": harness.read_json(
        harness.HERE / "traffic" / "train_b16.json"), "itemsize": 4, "profiled_steps": 2,
        "trace": {"device_events": [("vq_simt", 0.0, 0.002)]}}
    vq = 2 * least_seconds(*kernels.load("vq").pieces(p, train["mix"], 4)[0])[0]
    assert readers.roofline_pct(train, "vq") == pytest.approx(100 * vq / 0.002)
