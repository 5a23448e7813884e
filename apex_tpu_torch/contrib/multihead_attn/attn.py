"""Fused self and encoder-decoder multi-head attention modules.

PyTorch port of the JAX package's ``apex_tpu/contrib/multihead_attn/
attn.py`` (the reference's ``fast_*_multihead_attn`` family:
``SelfMultiheadAttn``, ``EncdecMultiheadAttn`` and their bias, norm-add
and additive-mask variants) as ``nn.Module``s.  Every variant is one code
path over :func:`apex_tpu_torch.ops.attention.flash_attention`, whose
kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) run on the card:

* ``bias``             -> bias terms on the projections;
* ``include_norm_add`` -> pre-LayerNorm (``ops.fused_layer_norm``) and the
  residual add;
* masks                -> the JAX package's routing, exactly: a boolean
  key-padding mask alone becomes segment ids (all-ones query ids, key ids
  1 = real, 0 = padding), which lets the kernels skip the padding tiles;
  anything else becomes an additive ``mask_bias`` (-10000 where a boolean
  mask is True, or the raw values under ``mask_additive``) passed as a
  broadcast view, never expanded per head.  The two routes differ on a
  row whose keys are all padded: the segment route returns zeros there,
  the additive route a softmax over the padded keys, as in JAX;
* ``dropout``          -> a Bernoulli keep-mask on the attention context
  (as the JAX modules apply it), drawn from the ``generator`` the caller
  passes to ``forward``; no global RNG is read.

Layout: [seq, batch, hidden], as the reference modules.  The projections'
outputs are split into heads as strided views [b, heads, s, d] (head
index b * heads + head, as the JAX modules' ``_split_heads``), the
kernels write the context in [s, b, heads, d] order and hand the
gradients back in the projections' [s, b, h] order, so no head transpose
is copied in either direction.  Parameter names are the JAX modules'
(``in_proj_weight`` [3h, h]; ``q_weight`` [h, h] and ``kv_weight``
[2h, h]; ``out_proj_weight``; the biases; ``lyr_nrm_gamma_weights`` and
``lyr_nrm_beta_weights``), so :mod:`.convert` carries a JAX ``init`` dict
over name for name.

Products: x @ W^T accumulated in fp32 from x's dtype (the weight cast to
it: a bf16 compute pass over fp32 master weights), the bias added in fp32,
the result cast back to x's dtype.  With fp32 inputs this is the JAX
modules' arithmetic.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.ops._gemm import linear_f32
from apex_tpu_torch.ops.attention import flash_attention
from apex_tpu_torch.ops.fused_layer_norm import layer_norm

#: the fill a boolean mask's True entries get on the additive route
_MASK_FILL = -10000.0


def _linear(x, weight, bias):
    y = linear_f32(x, weight)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[s, b, h] (a view, unit last stride) -> [b, heads, s, d], a view."""
    s, b, h = x.shape
    return x.view(s, b, heads, h // heads).permute(1, 2, 0, 3)


def _merge(ctx: torch.Tensor) -> torch.Tensor:
    """[b, heads, s, d] -> [s, b, heads * d]; a view when the kernel laid
    ctx out in [s, b, heads, d] order."""
    b, heads, s, d = ctx.shape
    return ctx.permute(2, 0, 1, 3).reshape(s, b, heads * d)


def _additive(mask: torch.Tensor, additive: bool) -> torch.Tensor:
    if additive:
        return mask.to(torch.float32)
    return torch.where(mask.bool(), _MASK_FILL, 0.0).to(torch.float32)


class SelfMultiheadAttn(nn.Module):
    """Reference ``SelfMultiheadAttn`` (self_multihead_attn.py:26), the
    JAX package's ``SelfMultiheadAttn``.

    Built on ``device`` (``None``: the card, raising without one;
    ``"cpu"`` runs the plain versions of the kernels) with weights drawn
    from ``seed`` as the JAX ``init`` draws them (uniform in
    [-1/sqrt(h), 1/sqrt(h)], zero biases, unit LayerNorm), in ``dtype``.
    ``impl`` and ``separate_qkv_params`` are taken for the reference's
    signature and, as in the JAX package, change nothing: one packed
    ``in_proj_weight`` and one fused path."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 impl: str = "fast", separate_qkv_params: bool = False,
                 mask_additive: bool = False, *, device=None, seed: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        del impl, separate_qkv_params  # one fused path, one packed weight
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.bias = bias
        self.include_norm_add = include_norm_add
        self.mask_additive = mask_additive
        self.scaling = (embed_dim // num_heads) ** -0.5
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self._make_params(dev, gen, dtype)

    def _uniform(self, shape, dev, gen, dtype):
        bound = 1.0 / math.sqrt(self.embed_dim)
        w = torch.rand(shape, generator=gen, device=dev, dtype=torch.float32)
        return nn.Parameter((w * (2 * bound) - bound).to(dtype))

    def _zeros(self, n, dev, dtype):
        return nn.Parameter(torch.zeros(n, device=dev, dtype=dtype))

    def _make_norm_and_out(self, dev, gen, dtype):
        h = self.embed_dim
        self.out_proj_weight = self._uniform((h, h), dev, gen, dtype)
        self.out_proj_bias = self._zeros(h, dev, dtype) if self.bias else None
        if self.include_norm_add:
            self.lyr_nrm_gamma_weights = nn.Parameter(
                torch.ones(h, device=dev, dtype=dtype))
            self.lyr_nrm_beta_weights = self._zeros(h, dev, dtype)

    def _make_params(self, dev, gen, dtype):
        h = self.embed_dim
        self.in_proj_weight = self._uniform((3 * h, h), dev, gen, dtype)
        self.in_proj_bias = (self._zeros(3 * h, dev, dtype) if self.bias
                             else None)
        self._make_norm_and_out(dev, gen, dtype)

    def _norm(self, x):
        if not self.include_norm_add:
            return x
        return layer_norm(x, self.lyr_nrm_gamma_weights,
                          self.lyr_nrm_beta_weights)

    def _attend(self, qh, kh, vh, key_padding_mask, attn_mask):
        """The JAX modules' routing; ``attn_mask`` (self-attention only)
        is None for the encoder-decoder module."""
        b, _, sq, _ = qh.shape
        if (key_padding_mask is not None and attn_mask is None
                and not self.mask_additive):
            # key-side masking as segment ids: all-ones query ids, key ids
            # 1 = real and 0 = padding, one id row per batch element
            keep = (~key_padding_mask.bool()).to(torch.int32)
            ones = torch.ones(b, sq, dtype=torch.int32, device=keep.device)
            return flash_attention(qh, kh, vh, segment_ids=(ones, keep),
                                   scale=self.scaling)
        mask_bias = None
        if key_padding_mask is not None:  # [b, sk] -> [b, 1, 1, sk]
            mask_bias = _additive(key_padding_mask, self.mask_additive)[
                :, None, None, :]
        if attn_mask is not None:
            am = _additive(attn_mask, self.mask_additive)
            if am.ndim == 3:  # [b*heads | 1, sq, sk]
                am = am[None] if am.shape[0] == 1 else am.view(
                    b, self.num_heads, *am.shape[1:])
            else:  # [sq, sk]
                am = am[None, None]
            mask_bias = am if mask_bias is None else mask_bias + am
        return flash_attention(qh, kh, vh, mask_bias=mask_bias,
                               scale=self.scaling)

    def _finish(self, ctx, residual, is_training, generator):
        ctx = _merge(ctx)
        if is_training and self.dropout > 0.0 and generator is not None:
            # the reference fuses dropout into its softmax kernel; the JAX
            # modules, and so this port, drop the context instead
            keep = torch.rand(ctx.shape, generator=generator,
                              device=ctx.device) < 1.0 - self.dropout
            ctx = torch.where(keep, ctx / (1.0 - self.dropout), 0.0).to(
                ctx.dtype)
        out = _linear(ctx, self.out_proj_weight, self.out_proj_bias)
        if self.include_norm_add:
            out = out + residual  # the norm-add variant's residual
        return out

    def forward(self, query: torch.Tensor, key: Optional[torch.Tensor] = None,
                value: Optional[torch.Tensor] = None, *,
                key_padding_mask: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None,
                is_training: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """query [seq, batch, hidden] -> [seq, batch, hidden].  ``key``
        and ``value`` are taken for the reference's signature and not
        read: self-attention reads ``query`` only.  Masks follow the
        reference: boolean (True = masked out) or, under
        ``mask_additive``, additive floats; ``key_padding_mask`` [batch,
        seq], ``attn_mask`` [seq, seq] or [batch*heads | 1, seq, seq].
        Context dropout needs ``is_training`` and a ``generator`` on the
        input's device."""
        del key, value
        s, b, h = query.shape
        qkv = _linear(self._norm(query), self.in_proj_weight,
                      self.in_proj_bias)
        q, k, v = (_heads(t, self.num_heads) for t in qkv.split(h, dim=-1))
        ctx = self._attend(q, k, v, key_padding_mask, attn_mask)
        return self._finish(ctx, query, is_training, generator)


class EncdecMultiheadAttn(SelfMultiheadAttn):
    """Reference ``EncdecMultiheadAttn`` (encdec_multihead_attn.py), the
    JAX package's: the query from the decoder, keys and values from the
    encoder (``key``; ``value`` is not read, as in JAX).  Only a
    key-padding mask over the encoder's positions applies; an
    ``attn_mask`` only turns the boolean key-padding mask onto the
    additive route, as in the JAX module."""

    def _make_params(self, dev, gen, dtype):
        h = self.embed_dim
        self.q_weight = self._uniform((h, h), dev, gen, dtype)
        self.kv_weight = self._uniform((2 * h, h), dev, gen, dtype)
        self.q_bias = self._zeros(h, dev, dtype) if self.bias else None
        self.kv_bias = self._zeros(2 * h, dev, dtype) if self.bias else None
        self._make_norm_and_out(dev, gen, dtype)

    def _attend(self, qh, kh, vh, key_padding_mask, attn_mask):
        if (key_padding_mask is not None and attn_mask is None
                and not self.mask_additive):
            return super()._attend(qh, kh, vh, key_padding_mask, None)
        mask_bias = None
        if key_padding_mask is not None:
            mask_bias = _additive(key_padding_mask, self.mask_additive)[
                :, None, None, :]
        return flash_attention(qh, kh, vh, mask_bias=mask_bias,
                               scale=self.scaling)

    def forward(self, query: torch.Tensor, key: Optional[torch.Tensor] = None,
                value: Optional[torch.Tensor] = None, *,
                key_padding_mask: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None,
                is_training: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """query [sq, batch, hidden] from the decoder, key [sk, batch,
        hidden] from the encoder (``None``: the query) ->
        [sq, batch, hidden].  ``key_padding_mask`` [batch, sk]."""
        del value
        h = query.shape[-1]
        enc = query if key is None else key
        q = _linear(self._norm(query), self.q_weight, self.q_bias)
        kv = _linear(enc, self.kv_weight, self.kv_bias)
        k, v = kv.split(h, dim=-1)
        ctx = self._attend(_heads(q, self.num_heads),
                           _heads(k, self.num_heads),
                           _heads(v, self.num_heads), key_padding_mask,
                           attn_mask)
        return self._finish(ctx, query, is_training, generator)
