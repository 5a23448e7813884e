"""The hand-written Hopper kernels of the package, as launchable objects.

Each :class:`~apex_tpu_torch.kernels._build.Kernel` wraps one C entry
point of one ``csrc/*.cu`` source (built with ``nvcc`` at first use) and
counts its launches.  The tensor-level wrappers that check arguments and
take the plain PyTorch versions for CPU tensors live beside those
versions in :mod:`apex_tpu_torch.ops.attention`,
:mod:`apex_tpu_torch.ops.fused_layer_norm`,
:mod:`apex_tpu_torch.optimizers.flat` and
:mod:`apex_tpu_torch.profiling.roofs`.
"""

import ctypes

import torch

from apex_tpu_torch.kernels._build import NvccError, Kernel, build_all, build_log

_p, _i, _f, _u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
_i64 = ctypes.c_int64
_strides = ctypes.POINTER(ctypes.c_int64)

#: the element types every kernel is built for, as its ``dtype`` argument
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: flash_fwd.cu — flash attention forward (the prefill's attention and the
#: generic ``flash_attention``)
FLASH_FWD = Kernel("flash_fwd.cu", "flash_fwd", [
    _i, _i, _i,                 # dtype, d, device
    _p, _p, _p, _p, _p,         # q, k, v, o, lse
    _p,                         # mask (fp32, or null)
    _p, _p, _i,                 # seg_q, seg_k, seg_div
    _i, _i, _i, _i,             # B, H, sq, sk
    _strides,                   # int64[13]: q, k/v, o strides of (b, h, s),
                                # mask strides of (b, h, row, col)
    _f, _i,                     # scale, causal
    _u, _u, _f,                 # dropout seed, threshold, keep prob
    _p,                         # stream
])

#: flash_fwd_sm90.cu — the same forward on the tensor cores (wgmma, TMA):
#: the route for bf16 at head dims 64 and 128 (flash_fwd.cu keeps fp32 and
#: head dim 8)
FLASH_FWD_SM90 = Kernel("flash_fwd_sm90.cu", "flash_fwd_sm90", [
    _i, _i,                     # d, device
    _p, _p, _p, _p, _p,         # q, k, v, o, lse
    _p,                         # mask (fp32, or null)
    _p, _p, _i,                 # seg_q, seg_k, seg_div
    _p,                         # visits (int32 tiles walked per block, or null)
    _i, _i, _i, _i,             # B, H, sq, sk
    _strides,                   # int64[16]: (b, h, s) of q, k, v, o; mask
                                # (b, h, row, col)
    _f, _i,                     # scale, causal
    _u, _u, _f,                 # dropout seed, threshold, 1 / keep prob
    _p,                         # stream
])

#: flash_bwd.cu — its backward: dq, dk, dv
FLASH_BWD = Kernel("flash_bwd.cu", "flash_bwd", [
    _i, _i, _i,                 # dtype, d, device
    _p, _p, _p, _p, _p,         # q, k, v, o, do
    _p, _p,                     # lse, delta (scratch)
    _p, _p, _p,                 # dq, dk, dv
    _p,                         # mask (fp32, or null)
    _p, _p, _i,                 # seg_q, seg_k, seg_div
    _p,                         # visits (int32 tiles walked per block, or null)
    _i, _i, _i, _i,             # B, H, sq, sk
    _strides,                   # int64[22]: (b, h, s) of q, k/v, o, do, dq,
                                # dk/dv; mask (b, h, row, col)
    _f, _i,                     # scale, causal
    _u, _u, _f,                 # dropout seed, threshold, 1 / keep prob
    _p,                         # stream
])

#: flash_bwd_sm90.cu — the same backward on the tensor cores (wgmma, TMA):
#: the route for bf16 at head dims 64 and 128 (flash_bwd.cu keeps fp32 and
#: head dim 8)
FLASH_BWD_SM90 = Kernel("flash_bwd_sm90.cu", "flash_bwd_sm90", [
    _i, _i,                     # d, device
    _p, _p, _p, _p, _p,         # q, k, v, o, do
    _p, _p,                     # lse, delta (scratch)
    _p, _p, _p,                 # dq, dk, dv
    _p,                         # mask (fp32, or null)
    _p, _p, _i,                 # seg_q, seg_k, seg_div
    _p,                         # visits (int32 tiles walked per block, or null)
    _i, _i, _i, _i,             # B, H, sq, sk
    _strides,                   # int64[28]: (b, h, s) of q, k, v, o, do, dq,
                                # dk, dv; mask (b, h, row, col)
    _f, _i,                     # scale, causal
    _u, _u, _f,                 # dropout seed, threshold, 1 / keep prob
    _p,                         # stream
])

#: flash_decode.cu — attention over the paged KV pool (the decode step)
FLASH_DECODE = Kernel("flash_decode.cu", "flash_decode", [
    _i, _i, _i,                 # dtype, d, device
    _p, _p, _p, _p,             # q, k_pages, v_pages, o
    _p, _p,                     # page_table, kv_len
    _i, _i, _i, _i, _i, _i,     # B, H, q_len, p_max, page_size, n_pages
    _strides,                   # int64[9]: q (b, h, row), pools (page,
                                # slot, head), o (b, h, row)
    _f, _p,                     # scale, stream
])

#: flash_decode_sm90.cu — the same attention at head dim 128, one entry
#: point a pool dtype so that launches count by pool: the bf16 pool
#: (flash_decode.cu keeps the fp32 pool and head dim 8), and the quantized
#: int8 and fp8 e4m3 pools with their fp32 scales
_FLASH_DECODE_SM90_ARGS = [
    _i, _i, _i,                 # q dtype, d, device
    _p, _p, _p,                 # q, k_pages, v_pages
    _p, _p,                     # k_scale, v_scale (fp32, or null)
    _p, _p,                     # o, work (fp32 split partials, or null)
    _p, _p,                     # page_table, kv_len
    _i, _i, _i, _i, _i, _i,     # B, H, q_len, p_max, page_size, n_pages
    _i,                         # max_splits
    _strides,                   # int64[12]: q (b, h, row), pools (page,
                                # slot, head), o (b, h, row), scales
                                # (page, slot, head)
    _f, _p,                     # scale, stream
]
FLASH_DECODE_SM90 = Kernel("flash_decode_sm90.cu", "flash_decode_sm90",
                           _FLASH_DECODE_SM90_ARGS)
FLASH_DECODE_SM90_INT8 = Kernel("flash_decode_sm90.cu",
                                "flash_decode_sm90_int8",
                                _FLASH_DECODE_SM90_ARGS)
FLASH_DECODE_SM90_FP8 = Kernel("flash_decode_sm90.cu",
                               "flash_decode_sm90_fp8",
                               _FLASH_DECODE_SM90_ARGS)

#: flash_qkv_fwd.cu — packed-QKV self-attention forward (training), one
#: entry point a head dim so that launches count by instance: 128 (GPT)
#: here, 64 (BERT-large) in FLASH_QKV_FWD_D64
_FLASH_QKV_FWD_ARGS = [
    _i, _i, _i,                 # dtype, d, device
    _p, _p, _p,                 # qkv, ctx, lse
    _p, _p, _i,                 # seg_q, seg_k, seg_div
    _i, _i, _i,                 # B, H, s
    _f, _i,                     # scale, causal
    _u, _u, _f,                 # dropout seed, threshold, keep prob
    _p,                         # stream
]
FLASH_QKV_FWD = Kernel("flash_qkv_fwd.cu", "flash_qkv_fwd",
                       _FLASH_QKV_FWD_ARGS)
FLASH_QKV_FWD_D64 = Kernel("flash_qkv_fwd.cu", "flash_qkv_fwd_d64",
                           _FLASH_QKV_FWD_ARGS)

#: flash_qkv_bwd.cu — its backward: dqkv in the packed layout (head dims
#: 128 and 64, as the forward)
_FLASH_QKV_BWD_ARGS = [
    _i, _i, _i,                 # dtype, d, device
    _p, _p, _p, _p, _p, _p,     # qkv, dctx, ctx, lse, delta (scratch), dqkv
    _p, _p, _i,                 # seg_q, seg_k, seg_div
    _i, _i, _i,                 # B, H, s
    _f, _i,                     # scale, causal
    _u, _u, _f,                 # dropout seed, threshold, 1 / keep prob
    _p,                         # stream
]
FLASH_QKV_BWD = Kernel("flash_qkv_bwd.cu", "flash_qkv_bwd",
                       _FLASH_QKV_BWD_ARGS)
FLASH_QKV_BWD_D64 = Kernel("flash_qkv_bwd.cu", "flash_qkv_bwd_d64",
                           _FLASH_QKV_BWD_ARGS)

#: flash_qkv_fwd_sm90.cu — the same forward on the tensor cores (wgmma, TMA):
#: the bf16 route (flash_qkv_fwd.cu stays the fp32 one), head dim 128 here
#: and 64 in FLASH_QKV_FWD_SM90_D64
_FLASH_QKV_FWD_SM90_ARGS = [
    _i, _i,                     # d, device
    _p, _p, _p,                 # qkv, ctx, lse
    _p, _p, _i,                 # seg_q, seg_k, seg_div
    _i, _i, _i,                 # B, H, s
    _f, _i,                     # scale, causal
    _u, _u, _f,                 # dropout seed, threshold, keep prob
    _p,                         # stream
]
FLASH_QKV_FWD_SM90 = Kernel("flash_qkv_fwd_sm90.cu", "flash_qkv_fwd_sm90",
                            _FLASH_QKV_FWD_SM90_ARGS)
FLASH_QKV_FWD_SM90_D64 = Kernel("flash_qkv_fwd_sm90.cu",
                                "flash_qkv_fwd_sm90_d64",
                                _FLASH_QKV_FWD_SM90_ARGS)

#: flash_qkv_bwd_sm90.cu — its backward on the tensor cores: the bf16
#: route, head dims 128 and 64 as the forward
_FLASH_QKV_BWD_SM90_ARGS = [
    _i, _i,                     # d, device
    _p, _p, _p, _p, _p, _p,     # qkv, dctx, ctx, lse, delta (scratch), dqkv
    _p, _p, _i,                 # seg_q, seg_k, seg_div
    _p,                         # visits (int32 tiles walked per block, or null)
    _i, _i, _i,                 # B, H, s
    _f, _i,                     # scale, causal
    _u, _u, _f,                 # dropout seed, threshold, 1 / keep prob
    _p,                         # stream
]
FLASH_QKV_BWD_SM90 = Kernel("flash_qkv_bwd_sm90.cu", "flash_qkv_bwd_sm90",
                            _FLASH_QKV_BWD_SM90_ARGS)
FLASH_QKV_BWD_SM90_D64 = Kernel("flash_qkv_bwd_sm90.cu",
                                "flash_qkv_bwd_sm90_d64",
                                _FLASH_QKV_BWD_SM90_ARGS)

#: layer_norm.cu — row LayerNorm forward (y, mean, invvar)
LAYER_NORM_FWD = Kernel("layer_norm.cu", "layer_norm_fwd", [
    _i, _i,                     # dtype, device
    _p, _p, _p,                 # x, weight, bias
    _p, _p, _p,                 # y, mean, invvar
    _i, _i, _f, _p,             # rows, cols, eps, stream
])

#: layer_norm.cu — its backward (dx; dweight, dbias by ordered partials)
LAYER_NORM_BWD = Kernel("layer_norm.cu", "layer_norm_bwd", [
    _i, _i,                     # dtype, device
    _p, _p, _p, _p, _p,         # x, dy, mean, invvar, weight
    _p, _p, _p, _p,             # dx, dweight, dbias, partials (scratch)
    _i, _i, _p,                 # rows, cols, stream
])

#: layer_norm_sm90.cu — the same forward with each row read once into
#: registers: the route for fp32 and bf16 at 1024, 2048 and 4096 columns
#: (layer_norm.cu keeps every other width)
LAYER_NORM_FWD_SM90 = Kernel("layer_norm_sm90.cu", "layer_norm_fwd_sm90", [
    _i, _i,                     # dtype, device
    _p, _p, _p,                 # x, weight, bias
    _p, _p, _p,                 # y, mean, invvar
    _i, _i, _f, _p,             # rows, cols, eps, stream
])

#: layer_norm_sm90.cu — its backward (one pass over x and dy; dweight,
#: dbias summed on chip a block, then over the blocks in a fixed order)
LAYER_NORM_BWD_SM90 = Kernel("layer_norm_sm90.cu", "layer_norm_bwd_sm90", [
    _i, _i,                     # dtype, device
    _p, _p, _p, _p, _p,         # x, dy, mean, invvar, weight
    _p, _p, _p, _p,             # dx, dweight, dbias, partials (scratch)
    _i, _i, _p,                 # rows, cols, stream
])

#: flat_adam.cu — Adam / AdamW over one span of a flat fp32 superblock
FLAT_ADAM = Kernel("flat_adam.cu", "flat_adam", [
    _i,                         # device
    _p, _p, _p, _p,             # p, g, m, v (p, m, v updated in place)
    _p, _i64,                   # scal (fp32 [3]: lr, c1, c2), n
    _f, _f, _f, _f, _f, _f,     # b1, 1 - b1, b2, 1 - b2, eps, wd
    _i, _p,                     # decay (0 none, 1 L2, 2 AdamW), stream
])

#: hbm_copy.cu — a byte copy, the HBM roof probe
HBM_COPY = Kernel("hbm_copy.cu", "hbm_copy", [
    _i,                         # device
    _p, _p, _i64,               # src, dst, bytes
    _p,                         # stream
])

#: attention_dots.cu — the two attention products with the bench's causal
#: tile skip, the attention dot floor
ATTENTION_DOTS = Kernel("attention_dots.cu", "attention_dots", [
    _i,                         # device
    _p, _p, _p, _p,             # q, k, v, o (bf16 [bh, s, d])
    _i, _i, _i,                 # bh, s, d
    _i, _i, _p,                 # block_q, block_k, stream
])

#: attention_dots_sm90.cu — the same floor on the tensor cores (wgmma, TMA):
#: the route of every input; attention_dots.cu is the route it replaced
ATTENTION_DOTS_SM90 = Kernel("attention_dots_sm90.cu", "attention_dots_sm90", [
    _i,                         # device
    _p, _p, _p, _p,             # q, k, v, o (bf16 [bh, s, d])
    _p,                         # visits (int32 sub-tiles per block, or null)
    _i, _i, _i,                 # bh, s, d
    _i, _i, _p,                 # block_q, block_k, stream
])

KERNELS = (FLASH_FWD, FLASH_FWD_SM90, FLASH_BWD, FLASH_BWD_SM90, FLASH_DECODE,
           FLASH_DECODE_SM90, FLASH_DECODE_SM90_INT8, FLASH_DECODE_SM90_FP8,
           FLASH_QKV_FWD, FLASH_QKV_BWD, FLASH_QKV_FWD_SM90, FLASH_QKV_BWD_SM90,
           FLASH_QKV_FWD_D64, FLASH_QKV_BWD_D64, FLASH_QKV_FWD_SM90_D64,
           FLASH_QKV_BWD_SM90_D64,
           LAYER_NORM_FWD, LAYER_NORM_BWD, LAYER_NORM_FWD_SM90,
           LAYER_NORM_BWD_SM90, FLAT_ADAM, HBM_COPY, ATTENTION_DOTS,
           ATTENTION_DOTS_SM90)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = ["NvccError", "Kernel", "build_all", "build_log", "DTYPE_CODES",
           "FLASH_FWD", "FLASH_FWD_SM90", "FLASH_BWD", "FLASH_BWD_SM90",
           "FLASH_DECODE", "FLASH_DECODE_SM90", "FLASH_DECODE_SM90_INT8",
           "FLASH_DECODE_SM90_FP8", "FLASH_QKV_FWD", "FLASH_QKV_BWD",
           "FLASH_QKV_FWD_SM90", "FLASH_QKV_BWD_SM90", "FLASH_QKV_FWD_D64",
           "FLASH_QKV_BWD_D64", "FLASH_QKV_FWD_SM90_D64",
           "FLASH_QKV_BWD_SM90_D64", "LAYER_NORM_FWD",
           "LAYER_NORM_BWD", "LAYER_NORM_FWD_SM90", "LAYER_NORM_BWD_SM90",
           "FLAT_ADAM", "HBM_COPY", "ATTENTION_DOTS", "ATTENTION_DOTS_SM90",
           "KERNELS", "reset_launch_counts"]
