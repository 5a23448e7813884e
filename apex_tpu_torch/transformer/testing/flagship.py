"""The GPT-1.3B flagship configuration.

PyTorch port of the configuration half of the JAX package's
``apex_tpu/transformer/testing/flagship.py``: hidden 2048 in 16 heads of
128, 24 layers, vocab 51200, 2048 positions, bf16, flash attention,
remat ``attn_res``.  The JAX module's ZeRO train step is not ported yet.
"""

from __future__ import annotations

from apex_tpu_torch.transformer.testing.standalone_gpt import GPTConfig

__all__ = ["GPT1P3B_KW", "gpt1p3b_config", "gpt_param_count"]

GPT1P3B_KW = dict(
    num_layers=24,
    hidden_size=2048,
    num_attention_heads=16,
    vocab_size=51200,
    max_position_embeddings=2048,
    bf16=True,
    use_flash_attention=True,
    remat=True,
    remat_policy="attn_res",
)


def gpt1p3b_config(**overrides) -> GPTConfig:
    """The 1.3B flagship :class:`GPTConfig`; ``overrides`` for toy-depth
    variants (keep ``hidden_size / num_attention_heads = 128`` so the
    head dim the kernels are built for stays the one under test)."""
    return GPTConfig(**{**GPT1P3B_KW, **overrides})


def gpt_param_count(cfg: GPTConfig) -> int:
    """Analytic parameter count of the standalone GPT (biases and
    layernorms included): per layer 12h^2 GEMM weights + 13h vectors,
    plus word/position embeddings and the final layernorm."""
    h, L = cfg.hidden_size, cfg.num_layers
    per_layer = 12 * h * h + 13 * h
    return (L * per_layer
            + (cfg.vocab_size + cfg.max_position_embeddings) * h
            + 2 * h)
