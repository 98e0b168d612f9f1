"""The port's entry points on the CPU (``--device cpu``), at tiny widths.

Both chains of the README's quickstart through the port's own commands:
generate Moving MNIST, train the first stage (``cli.train_vqvae`` for
MAGE, ``cli.train_autoencoder_kl`` for MAGE+), train stage 2 with
``cli.main_mage --split train`` on a config whose first stage loads that
checkpoint, then sample with ``--split test``. The configs are
``tests/test_cli.py``'s tiny YAML (MAGE) and its MAGE+ twin, with the
targets left as ``mage_tpu.*`` so the port's prefix rewrite resolves them.
The CLI's samples must equal ``MagePipeline.generate`` on the restored
weights, exactly (the same CPU computation).
"""

import os
import pathlib

import numpy as np
import pytest
import torch

from mage_tpu_torch.cli import main_mage, train_autoencoder_kl, train_vqvae
from mage_tpu_torch.config import get_obj_from_str, instantiate_from_config, load_config
from mage_tpu_torch.data import datasets as port_datasets
from mage_tpu_torch.data.generators.mnist_single import main as gen_main
from mage_tpu_torch.data.loader import Loader
from mage_tpu_torch.models.pipeline import FirstStageKL, FirstStageVQVAE
from mage_tpu_torch.utils import media

ROOT = pathlib.Path(__file__).resolve().parent.parent

TEXT_AND_MA = """
    text_encoder_config:
      target: mage_tpu.models.layers.TransformerTextEncoder
      params: {{vocab_size: 30, context_length: 16, transformer_width: 32,
               transformer_layers: 1, output_dim: 32, padding_idx: 0, dropout: 0.1}}
    ma_config:
      target: mage_tpu.models.layers.MAEncoder
      params: {{layers: 1, d_model: 32}}
"""
DATA = """
data:
  target: mage_tpu.data.datasets.MovingMnist
  params:
    data_root: '{root}/mnist_single_20f_10k_'
    frames_length: 4
    sample_speed: [1.0, 2.0]
    context_length: 16
"""
MAGE_YAML = """
train: {{epoch: 1, batchsize: 8, lr: 1e-3, cos: true, checkpoint_every: 2}}
model:
  target: mage_tpu.models.pipeline.MagePipeline
  params:
    codebook_size: 8
    frames_length: 4
    image_resolution: 16
    vision_width: 32
    dropout: 0.1
    use_cids: true
    randomness: false
    first_stage_config:
      target: mage_tpu.models.vqvae.VectorQuantizedVAE
      params: {{input_dim: 1, dim: 16, down_ratio: 4, K: 8, ckpt_path: '{ckpt}'}}
""" + TEXT_AND_MA + """
    generate_decoder_config:
      target: mage_tpu.models.mage.FlatAxialDecoder
      params: {{in_channels: 32, out_channels: 8, model_channels: 32,
               frames_length: 4, layers: 3}}
""" + DATA
# MAGE+: the KL-AE first stage, continuous latents, auto-beta and bf16
# training as config/mage+_mnist.yaml ships them
MAGEP_YAML = """
train: {{epoch: 1, batchsize: 8, lr: 1e-3, cos: true, checkpoint_every: 2, bf16: true}}
model:
  target: mage_tpu.models.pipeline.MagePipeline
  params:
    codebook_size: 8
    frames_length: 4
    image_resolution: 16
    vision_width: 32
    dropout: 0.1
    use_cids: false
    randomness: true
    auto_beta: true
    v_kl: 10
    first_stage_config:
      target: mage_tpu.models.autoencoder_kl.AutoencoderKL
      params:
        embed_dim: 4
        ckpt_path: '{ckpt}'
        ddconfig: {{double_z: true, z_channels: 4, resolution: 64, in_channels: 1,
                   out_ch: 1, ch: 32, ch_mult: [1, 1, 2], num_res_blocks: 1,
                   attn_resolutions: []}}
""" + TEXT_AND_MA + """
    generate_decoder_config:
      target: mage_tpu.models.mage.FlatAxialDecoder
      params: {{in_channels: 32, out_channels: 4, model_channels: 32,
               frames_length: 4, layers: 3}}
""" + DATA


def _train_first_stage(model: str, tmp: pathlib.Path) -> pathlib.Path:
    common = ["--data-root", str(tmp) + "/mnist_single_20f_10k_", "--dataset", "mnist",
              "--batch-size", "8", "--num-epochs", "1", "--lr", "1e-3",
              "--log-folder", str(tmp / "logs"), "--log-every", "1", "--device", "cpu"]
    if model == "mage":
        train_vqvae.main(common + ["--hidden-size", "16", "--k", "8", "--output-folder", "t",
                                   "--model-folder", str(tmp / "models")])
        return tmp / "models" / "t"
    train_autoencoder_kl.main(common + ["--resolution", "64", "--ch", "32", "--ch-mult", "1",
                                        "1", "2", "--num-res-blocks", "1", "--output-folder",
                                        "kl", "--model-folder", str(tmp / "autoencoders")])
    return tmp / "autoencoders" / "kl"


def _run_chain(model: str, tmp: pathlib.Path) -> dict:
    gen_main(["--out", str(tmp), "--num-train", "16", "--num-val", "8", "--seed", "1"])
    stage1 = _train_first_stage(model, tmp)
    cfg_path = tmp / "cfg.yaml"
    yaml = MAGE_YAML if model == "mage" else MAGEP_YAML
    cfg_path.write_text(yaml.format(root=tmp, ckpt=stage1 / "best"))
    ckpt_dir = tmp / "ckpt"
    main_mage.main(["--config", str(cfg_path), "--split", "train",
                    "--checkpoint-path", str(ckpt_dir), "--device", "cpu"])
    return {"tmp": tmp, "stage1": stage1, "ckpt": ckpt_dir}


@pytest.fixture(scope="module", params=["mage", "mage+"])
def chain(request, tmp_path_factory):
    """Generate, stage 1 and stage-2 training, once per model."""
    name = request.param.replace("+", "p")
    return request.param, _run_chain(request.param, tmp_path_factory.mktemp(name))


def test_chain_writes_each_stage_input(chain):
    model, run = chain
    stage1, ckpt = run["stage1"], run["ckpt"]
    # the port's layout: one torch.save file per checkpoint
    assert (stage1 / "best").is_file() and (stage1 / "model_1").is_file()
    assert (run["tmp"] / "logs" / stage1.name / "metrics.jsonl").exists()
    state = torch.load(stage1 / "best", weights_only=True)
    assert sorted(state) == ["optimizer", "state_dict", "step"] and state["step"] == 2
    cfg = load_config(ckpt / "config.yaml")
    assert cfg == load_config(run["tmp"] / "cfg.yaml")  # the snapshot
    first_stage = (FirstStageVQVAE if model == "mage" else FirstStageKL).from_config(
        cfg.model.params.first_stage_config.params)  # strict load of stage 1
    for key, value in state["state_dict"].items():
        torch.testing.assert_close(first_stage.model.state_dict()[key], value, rtol=0, atol=0)
    assert (ckpt / "model_best").is_file() and (ckpt / "iteration_2").is_file()
    assert sorted(torch.load(ckpt / "model_best", weights_only=True)) == [
        "model", "optimizer", "step"]
    assert (ckpt / "trainer_state.json").exists()


@pytest.mark.parametrize("extra,items", [([], 1), (["--sample-batch-size", "2", "--bf16"], 2)])
def test_cli_sampling_writes_gifs(chain, extra, items):
    _, run = chain
    ckpt = run["ckpt"]
    done = main_mage.main(["--split", "test", "--test_model", str(ckpt / "model_best"),
                           "--max-test-items", str(items), "--device", "cpu", *extra])
    assert done == items
    gifs = sorted((ckpt / "videos").glob("sample_*.gif"))
    assert len(gifs) >= items


def test_cli_sample_equals_pipeline_generate(chain, monkeypatch):
    """The CLI's clipped samples == ``generate`` on the weights restored by
    hand, for the first shuffled test batch and the same seeded generator."""
    _, run = chain
    ckpt = run["ckpt"]
    saved = {}
    monkeypatch.setattr(media, "save_gif",
                        lambda video, path, fps=3: saved.__setitem__(path, np.array(video)))
    assert main_mage.main(["--split", "test", "--test_model", str(ckpt / "model_best"),
                           "--max-test-items", "2", "--sample-batch-size", "2",
                           "--seed", "4", "--device", "cpu"]) == 2

    cfg = load_config(ckpt / "config.yaml")
    pipe = instantiate_from_config(cfg.model, merge={"device": "cpu", "seed": 4})
    pipe.core.load_state_dict(torch.load(ckpt / "model_best", weights_only=True)["model"])
    test = instantiate_from_config(cfg.data, {"split": "test", "seed": 4})
    batch = next(iter(Loader(test, 2, shuffle=True, seed=4, drop_last=True)))
    want = pipe.generate(batch, generator=torch.Generator().manual_seed(4))
    want = np.clip(want.numpy(), -1.0, 1.0)
    assert len(saved) == 2
    for i in range(2):
        name = f"sample_{i}-{float(batch['speed'][i]):.4f}.gif"
        np.testing.assert_array_equal(saved[os.path.join(ckpt, "videos", name)], want[i])


@pytest.mark.parametrize("cli,argv", [
    (train_vqvae, ["--data-root", "missing_"]),
    (train_autoencoder_kl, ["--data-root", "missing_"]),
    (main_mage, ["--config", "missing.yaml"]),
    (main_mage, ["--split", "test", "--test_model", "missing/model_best"]),
])
def test_cli_device_defaults_to_cuda_and_raises_without_a_gpu(cli, argv, monkeypatch):
    assert cli.parse_args(argv).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)


@pytest.mark.parametrize("name", sorted(p.name for p in (ROOT / "config").glob("*.yaml")))
def test_shipped_config_data_targets_resolve_to_port_classes(name):
    cfg = load_config(ROOT / "config" / name)
    cls = get_obj_from_str(cfg.data.target)
    assert cls.__module__ == port_datasets.__name__
    assert getattr(port_datasets, cls.__name__) is cls
    assert cls.__name__ == cfg.data.target.rsplit(".", 1)[1]
