"""Plain PyTorch reference of MAGE and MAGE+ (the published Make It Move
architecture), written from the model description and the reference YAML.

It reads weights by their reference state-dict names from a plain dict of
tensors, computes in float32 (TF32 off, see ``float32_math``), and knows
nothing of any program under test: no kernels, no cache, no batching tricks.
Every matrix product and convolution sends its two operands through
``self.q``, the identity here; the benchmark's control puts an fp8 rounding
there to compute the same reference in a lower precision.

Pieces:

- ``vq_latents``, ``vq_distances`` and ``vq_decode``: the f8 VQ-VAE (a 7x7 stem, four bottleneck
  encoder blocks with three 2x max-pools, nearest-code search; four decoder
  blocks with a 2x nearest upsample before each of the last three, as the
  published ``nn.Sequential`` has them).
- ``kl_moments`` / ``kl_decode``: the ldm KL autoencoder (ResNet blocks with
  GroupNorm(32) + SiLU, mid attention, stride-2 pad-then-conv downsamples,
  nearest-then-conv upsamples).
- ``prepare``: text encoder (post-LN), motion-anchor cross attention, the
  prior branch (conv_d2 and AdaIN) and the speed embedding.
- ``trunk``: the axial decoder teacher-forced over the motion anchor and the
  given frames, causal along T.
- ``logits`` (discrete head) and ``causal_head`` (the continuous head, its
  GroupNorm statistics taken over the generated slots up to each one, as the
  cached sampler of the published MAGE+ code does).
- ``posterior`` and ``train_terms``: the discrete model's training loss,
  with dropout where the model has it (text embeddings, the text layers'
  attention weights, residual branches and MLP hidden layer, the motion
  anchor's and the decoder's residual branches), each site applying the
  mask that ``masks`` (``reference.train.MaskFeed``) holds for it.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Mapping

import torch
import torch.nn.functional as F

FS = "first_stage_model."
NEG_INF = -1e9


@contextlib.contextmanager
def float32_math():
    """True float32 products (no TF32) inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale (amax / 448), and
    back to float32: what an fp8 matrix product takes as an operand."""
    scale = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 and back to float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class Reference:
    """The reference over ``weights`` (name -> tensor, any float dtype: read
    as float32). ``q`` rounds every operand of a product (identity: float32).
    ``cfg`` is the model section of the configuration (``model.params``)."""

    def __init__(self, weights: Mapping[str, torch.Tensor], cfg: Mapping,
                 q: Callable[[torch.Tensor], torch.Tensor] = lambda t: t):
        self.w = weights
        self.q = q
        self.use_cids = bool(cfg["use_cids"])
        self.randomness = bool(cfg.get("randomness", False))
        self.L = int(cfg["frames_length"])
        self.r = int(cfg["image_resolution"])
        te = cfg["text_encoder_config"]["params"]
        self.text_layers = int(te["transformer_layers"])
        self.text_heads = int(te["transformer_width"]) // 32
        self.padding_idx = int(te.get("padding_idx", 0))
        self.ma_layers = int(cfg["ma_config"]["params"]["layers"])
        self.dec_layers = int(cfg["generate_decoder_config"]["params"]["layers"])
        self.width = int(cfg["ma_config"]["params"]["d_model"])
        fs = cfg["first_stage_config"]["params"]
        self.dd = fs.get("ddconfig")
        self.codebook_size = int(cfg["codebook_size"])
        self.drop_rate = float(cfg.get("dropout", 0.1))
        self.text_drop_rate = float(te.get("dropout", self.drop_rate))
        self.masks = None  # a MaskFeed in a training step: dropout as the program drew it

    # ---- primitives ----------------------------------------------------------

    def p(self, name: str) -> torch.Tensor:
        return self.w[name].float()

    def linear(self, x, name, bias=True):
        b = self.p(name + ".bias") if bias else None
        return F.linear(self.q(x), self.q(self.p(name + ".weight")), b)

    def conv(self, x, name, stride=1, padding=None, bias=True):
        wt = self.p(name + ".weight")
        pad = wt.shape[-1] // 2 if padding is None else padding
        b = self.p(name + ".bias") if bias and name + ".bias" in self.w else None
        fn = F.conv3d if wt.ndim == 5 else F.conv2d
        return fn(self.q(x), self.q(wt), b, stride=stride, padding=pad)

    def layer_norm(self, x, name, eps=1e-5):
        return F.layer_norm(x, x.shape[-1:], self.p(name + ".weight"), self.p(name + ".bias"),
                            eps)

    def group_norm(self, x, name, groups, eps):
        return F.group_norm(x, groups, self.p(name + ".weight"), self.p(name + ".bias"), eps)

    def dropout(self, x, site):
        """Inverted dropout at ``site`` (the name of the layer that drops)
        with the next mask the feed holds for it; none outside a training
        step."""
        rate = self.text_drop_rate if site.startswith("text_encoder.") else self.drop_rate
        if self.masks is None or rate == 0:
            return x
        return x * self.masks.next(site).reshape(x.shape) / (1.0 - rate)

    def attention(self, xq, xk, xv, name, heads, bias=None, weight_drop=None):
        """Multi-head attention over (..., S, D) with torch's packed in-proj;
        ``weight_drop`` names the dropout site of its attention weights."""
        d = xq.shape[-1]
        w, b = self.p(name + ".in_proj_weight"), self.p(name + ".in_proj_bias")
        q = F.linear(self.q(xq), self.q(w[:d]), b[:d])
        k = F.linear(self.q(xk), self.q(w[d:2 * d]), b[d:2 * d])
        v = F.linear(self.q(xv), self.q(w[2 * d:]), b[2 * d:])
        hd = d // heads
        q, k, v = (t.unflatten(-1, (heads, hd)).transpose(-3, -2) for t in (q, k, v))
        scores = torch.matmul(self.q(q), self.q(k).transpose(-1, -2)) / math.sqrt(hd)
        if bias is not None:
            scores = scores + bias
        weights = torch.softmax(scores, dim=-1)
        if weight_drop is not None:
            weights = self.dropout(weights, weight_drop)
        out = torch.matmul(self.q(weights), self.q(v))
        return self.linear(out.transpose(-3, -2).flatten(-2), name + ".out_proj")

    def mlp(self, x, name):
        return self.linear(_quick_gelu(self.linear(x, name + ".c_fc")), name + ".c_proj")

    # ---- f8 VQ-VAE -----------------------------------------------------------

    def _bottleneck(self, x, name):
        """An encoder or decoder block: (relu, conv) x4 plus the identity or
        a 1x1 id path."""
        idp = self.conv(x, name + ".id_path") if name + ".id_path.weight" in self.w else x
        h = x
        for i in (1, 3, 5, 7):
            h = self.conv(F.relu(h), f"{name}.block.{i}")
        return idp + h

    def vq_latents(self, frames):
        """(N, H, W, 3) frames -> (N, h, w, D) encoder outputs."""
        x = self.conv(frames.float().permute(0, 3, 1, 2), FS + "encoder.0")
        for i in (1, 3, 5):
            x = F.max_pool2d(self._bottleneck(x, f"{FS}encoder.{i}"), 2)
        x = F.relu(self._bottleneck(x, FS + "encoder.7"))
        return x.permute(0, 2, 3, 1)

    def vq_distances(self, z):
        """(..., D) -> (..., K) squared distances to every code."""
        cb = self.p(FS + "codebook.embedding.weight")
        zf = z.reshape(-1, z.shape[-1])
        d = (zf * zf).sum(1, keepdim=True) - 2.0 * self.q(zf) @ self.q(cb).T + (cb * cb).sum(1)
        return d.reshape(*z.shape[:-1], cb.shape[0])

    def vq_decode(self, ids):
        """(N, h, w) ids -> (N, H, W, 3) frames."""
        x = self.p(FS + "codebook.embedding.weight")[ids.long()].permute(0, 3, 1, 2)
        x = self._bottleneck(x, FS + "decoder.0")
        for i in (2, 4, 6):
            x = self._bottleneck(F.interpolate(x, scale_factor=2, mode="nearest"),
                                f"{FS}decoder.{i}")
        x = torch.tanh(self.conv(F.relu(x), FS + "decoder.8"))
        return x.permute(0, 2, 3, 1)

    # ---- KL autoencoder --------------------------------------------------------

    def _resnet(self, x, name):
        h = self.conv(F.silu(self.group_norm(x, name + ".norm1", 32, 1e-6)), name + ".conv1")
        h = self.conv(F.silu(self.group_norm(h, name + ".norm2", 32, 1e-6)), name + ".conv2")
        if name + ".nin_shortcut.weight" in self.w:
            x = self.conv(x, name + ".nin_shortcut")
        return x + h

    def _kl_attn(self, x, name):
        b, c, hh, ww = x.shape
        h = self.group_norm(x, name + ".norm", 32, 1e-6)
        q, k, v = (self.conv(h, f"{name}.{m}").reshape(b, c, hh * ww).transpose(1, 2)
                   for m in ("q", "k", "v"))
        att = torch.softmax(torch.matmul(self.q(q), self.q(k).transpose(1, 2)) / math.sqrt(c),
                            dim=-1)
        out = torch.matmul(self.q(att), self.q(v)).transpose(1, 2).reshape(b, c, hh, ww)
        return x + self.conv(out, name + ".proj_out")

    def _mid(self, x, name):
        x = self._resnet(x, name + ".block_1")
        x = self._kl_attn(x, name + ".attn_1")
        return self._resnet(x, name + ".block_2")

    def kl_moments(self, frames):
        """(N, H, W, 3) frames -> (N, h, w, 2z) posterior moments."""
        dd = self.dd
        levels, blocks = len(dd["ch_mult"]), int(dd["num_res_blocks"])
        x = self.conv(frames.float().permute(0, 3, 1, 2), FS + "encoder.conv_in")
        for i in range(levels):
            for j in range(blocks):
                x = self._resnet(x, f"{FS}encoder.down.{i}.block.{j}")
            if i != levels - 1:
                x = self.conv(F.pad(x, (0, 1, 0, 1)), f"{FS}encoder.down.{i}.downsample.conv",
                              stride=2, padding=0)
        x = self._mid(x, FS + "encoder.mid")
        x = self.conv(F.silu(self.group_norm(x, FS + "encoder.norm_out", 32, 1e-6)),
                      FS + "encoder.conv_out")
        return self.conv(x, FS + "quant_conv").permute(0, 2, 3, 1)

    def kl_sample(self, frames, noise):
        mean, logvar = self.kl_moments(frames).chunk(2, dim=-1)
        return mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise.float()

    def kl_decode(self, z):
        """(N, h, w, z) latents -> (N, H, W, 3) frames."""
        dd = self.dd
        levels, blocks = len(dd["ch_mult"]), int(dd["num_res_blocks"])
        x = self.conv(z.float().permute(0, 3, 1, 2), FS + "post_quant_conv")
        x = self.conv(x, FS + "decoder.conv_in")
        x = self._mid(x, FS + "decoder.mid")
        for i in reversed(range(levels)):
            for j in range(blocks + 1):
                x = self._resnet(x, f"{FS}decoder.up.{i}.block.{j}")
            if i != 0:
                x = self.conv(F.interpolate(x, scale_factor=2, mode="nearest"),
                              f"{FS}decoder.up.{i}.upsample.conv")
        x = self.conv(F.silu(self.group_norm(x, FS + "decoder.norm_out", 32, 1e-6)),
                      FS + "decoder.conv_out")
        return x.permute(0, 2, 3, 1)

    # ---- stage 2 ---------------------------------------------------------------

    def embed(self, latents):
        """ids (B, T, h, w) or latents (B, T, h, w, z) -> (B, T, h, w, C)."""
        if self.use_cids:
            return self.p("visual_token_embedding.weight")[latents.long()]
        return self.linear(latents.float(), "visual_token_embedding")

    def stem(self, emb):
        b, t, h, w, c = emb.shape
        x = self.conv(emb.reshape(b * t, h, w, c).permute(0, 3, 1, 2), "conv.0", bias=False)
        x = x.permute(0, 2, 3, 1).reshape(b, t, h, w, c)
        return x + self.p("H_positional_embedding") + self.p("W_positional_embedding")

    def text(self, ids):
        ids = ids.long()
        n = ids.shape[-1]
        x = self.p("text_encoder.token_embedding.weight")[ids]
        x = x + self.p("text_encoder.positions.weight")[:n]
        x = self.dropout(self.layer_norm(x, "text_encoder.layer_norm", eps=1e-8),
                         "text_encoder.drop")
        keep = ids != self.padding_idx
        x = x * keep[..., None].float()
        length = keep.sum(-1, keepdim=True)
        masked = length < torch.arange(1, n + 1, device=ids.device)  # positions past the caption
        bias = torch.where(masked, NEG_INF, 0.0)[:, None, None, :]
        for i in range(self.text_layers):
            name = f"text_encoder.transformer.layers.{i}"
            h = self.attention(x, x, x, name + ".self_attn", self.text_heads, bias,
                               weight_drop=name + ".self_attn.weight_dropout")
            x = self.layer_norm(x + self.dropout(h, name + ".drop"), name + ".norm1")
            h = self.dropout(F.gelu(self.linear(x, name + ".linear1")), name + ".drop")
            h = self.linear(h, name + ".linear2")
            x = self.layer_norm(x + self.dropout(h, name + ".drop"), name + ".norm2")
        x = self.layer_norm(x, "text_encoder.ln_text_final")
        return self.linear(x, "text_encoder.text_projection")

    def motion_anchor(self, first_tokens, text_emb, video_emb, speed):
        b = first_tokens.shape[0]
        x = first_tokens
        heads = self.width // 32
        for i in range(self.ma_layers):
            name = f"ma_encoder.blocks.{i}"
            if self.use_cids:
                h = self.attention(x, text_emb, text_emb, name + ".attn", heads)
            else:
                kv = self.layer_norm(text_emb, name + ".ln_kv")
                h = self.attention(self.layer_norm(x, name + ".ln_q"), kv, kv,
                                   name + ".attn", heads)
            x = x + self.dropout(h, name + ".drop")
            h = self.mlp(self.layer_norm(x, name + ".ln_2"), name + ".mlp")
            x = x + self.dropout(h, name + ".drop")
        anchor = x.reshape(b, self.r, self.r, -1)
        if self.randomness:
            cond = self.conv(video_emb.float().permute(0, 3, 1, 2), "conv_d2", bias=False)
            mean = anchor.mean(dim=(1, 2), keepdim=True)
            var = anchor.var(dim=(1, 2), keepdim=True, unbiased=False)
            normed = (anchor - mean) * torch.rsqrt(var + 1e-5)
            gamma = self.conv(self.conv(cond, "adain.conv_mu.0"), "adain.conv_mu.1")
            beta = self.conv(self.conv(cond, "adain.conv_var.0"), "adain.conv_var.1")
            anchor = gamma.permute(0, 2, 3, 1) * normed + beta.permute(0, 2, 3, 1)
        if speed is not None:
            anchor = anchor + (speed.float().reshape(b, 1) @ self.p("speed_embedding"))[:, None,
                                                                                        None]
        return anchor

    def prepare(self, first_emb_stem, text, speed, video_noise):
        """The motion anchor (B, h, w, C) from the first frame's stem output
        (B, h, w, C), the caption ids, the speed and the prior sample."""
        b, h, w, c = first_emb_stem.shape
        return self.motion_anchor(first_emb_stem.reshape(b, h * w, c), self.text(text),
                                  video_noise, speed)

    def _axial_block(self, x, i):
        """Block i along its axis (i % 3: T causal, H, W) of (B, T, h, w, C)."""
        name = f"generate_model.blocks.{i}"
        axis = i % 3 + 1
        seq = torch.movedim(x, axis, -2)
        bias = None
        if axis == 1:
            n = seq.shape[-2]
            bias = torch.triu(torch.full((n, n), NEG_INF, device=x.device), diagonal=1)
        h = self.layer_norm(seq, name + ".ln_1")
        h = self.attention(h, h, h, name + ".attn", self.width // 32, bias)
        seq = seq + self.dropout(h, name + ".resid_dropout")
        h = self.mlp(self.layer_norm(seq, name + ".ln_2"), name + ".mlp")
        seq = seq + self.dropout(h, name + ".resid_dropout")
        return torch.movedim(seq, -2, axis)

    def trunk(self, anchor, frames_stem):
        """anchor (B, h, w, C) and stem outputs of the frames fed in
        (B, T, h, w, C) -> the decoder's residual stream at the T frame
        positions (B, T, h, w, C), position t predicting frame t + 1."""
        x = torch.cat([self.linear(anchor, "generate_model.context_linear")[:, None],
                       self.linear(frames_stem, "generate_model.in_linear")], dim=1)
        x = x + self.p("generate_model.T_positional_embedding")[:x.shape[1]]
        for i in range(self.dec_layers):
            x = self._axial_block(x, i)
        return x[:, 1:]

    def logits(self, trunk):
        return self.linear(trunk, "generate_model.out")

    def causal_head(self, trunk, groups=32, eps=1e-5):
        """Continuous head over (B, T, h, w, C), each position normalised by
        the GroupNorm statistics of positions 0..t -> (B, T, h, w, z)."""
        b, t, h, w, c = trunk.shape
        xg = trunk.reshape(b, t, h * w, groups, c // groups)
        count = torch.arange(1, t + 1, device=trunk.device, dtype=torch.float32)
        count = (count * h * w * (c // groups))[None, :, None]
        mean = xg.sum(dim=(2, 4)).cumsum(1) / count
        var = ((xg * xg).sum(dim=(2, 4)).cumsum(1) / count - mean * mean).clamp(min=0.0)
        xn = (xg - mean[:, :, None, :, None]) * torch.rsqrt(var[:, :, None, :, None] + eps)
        xn = xn.reshape(b, t, h, w, c) * self.p("generate_model.out.0.weight")
        xn = xn + self.p("generate_model.out.0.bias")
        wt = self.p("generate_model.out.2.weight").flatten(1)
        return F.linear(self.q(F.silu(xn)), self.q(wt), self.p("generate_model.out.2.bias"))

    # ---- stage-2 training --------------------------------------------------------

    def posterior(self, emb):
        """The 3D-conv pyramid over the whole embedded video (B, L, h, w, C):
        residual blocks of (conv 3x3x3 stride (2, 1, 1), GroupNorm(16), relu,
        conv 3x3x3, GroupNorm(16)) plus a strided conv and GroupNorm on the
        skip, then relu; T left above 1 is averaged -> (mu, logvar), each
        (B, h, w, 64)."""
        x = emb.permute(0, 4, 1, 2, 3)
        i = 0
        while f"conv3d.{i}.conv1.weight" in self.w:
            name = f"conv3d.{i}"
            h = F.relu(self.group_norm(self.conv(x, name + ".conv1", stride=(2, 1, 1)),
                                       name + ".bn1", 16, 1e-5))
            h = self.group_norm(self.conv(h, name + ".conv2"), name + ".bn2", 16, 1e-5)
            if name + ".downsample.0.weight" in self.w:
                x = self.group_norm(self.conv(x, name + ".downsample.0", stride=(2, 1, 1)),
                                    name + ".downsample.1", 16, 1e-5)
            x = F.relu(h + x)
            i += 1
        x = x.mean(dim=2) if x.shape[2] > 1 else x.squeeze(2)
        return (self.conv(x, "conv_mu2").permute(0, 2, 3, 1),
                self.conv(x, "conv_var2").permute(0, 2, 3, 1))

    def train_terms(self, ids, text, speed, posterior_noise, beta, alpha) -> dict:
        """The discrete model's teacher-forced training loss on the clips'
        ids (B, L, h, w): token cross-entropy of frames 1..L-1, beta times
        the posterior's KL to the standard normal and alpha times the
        speed embedding's mean squared norm, with the posterior sampled as
        mu + noise * exp(logvar / 2)."""
        if not self.use_cids:
            raise NotImplementedError("the reference trains the discrete model only")
        b = ids.shape[0]
        emb = self.embed(ids)
        fed = self.stem(emb[:, :self.L - 1])
        mu, logvar = self.posterior(emb)
        video_emb = mu + posterior_noise.float() * torch.exp(0.5 * logvar)
        anchor = self.motion_anchor(fed[:, 0].reshape(b, self.r * self.r, -1), self.text(text),
                                    video_emb, speed)
        logits = self.logits(self.trunk(anchor, fed))
        prediction = F.cross_entropy(logits.reshape(-1, self.codebook_size),
                                     ids[:, 1:self.L].long().reshape(-1))
        mu, logvar = mu.reshape(b, -1), logvar.reshape(b, -1)
        kl = -0.5 * (1 + logvar - mu * mu - torch.exp(logvar)).sum(1).mean()
        emb_speed = speed.float().reshape(-1, 1) @ self.p("speed_embedding")
        speed_l2 = (emb_speed * emb_speed).sum(-1).mean()
        return {"prediction": prediction, "kl_loss": kl, "speed_l2": speed_l2,
                "final_loss": prediction + beta * kl + alpha * speed_l2}
