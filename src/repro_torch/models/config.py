"""Model configuration (copy of ``repro.models.config`` for the port).

``ModelConfig`` is the superset of knobs the published configs in
``repro_torch/configs`` set; derived and padded values (vocab padded for
tensor-parallel divisibility, head dims) are computed here.  ``torch_dtype``
takes the place of the JAX package's ``jdtype``.
"""
from __future__ import annotations

import dataclasses

import torch


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | ssm | hybrid | moe | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # attention
    head_dim: int = 0           # 0 → d_model // n_heads
    qk_norm: bool = False       # chameleon
    rope_theta: float = 10_000.0
    window: int = 0             # >0 → sliding-window (local) attention
    attn_logit_softcap: float = 0.0

    # FFN
    act: str = "swiglu"         # swiglu | relu2 | geglu

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0  # leading layers with dense FFN (DeepSeek style)
    capacity_factor: float = 1.25  # training's (lm_loss, A13d); the port runs full capacity
    router_noise: float = 0.0

    # MLA (deepseek-v2)
    use_mla: bool = False
    kv_lora: int = 0
    q_lora: int = 0
    rope_head_dim: int = 64      # decoupled rope dims per head for MLA
    v_head_dim: int = 0

    # SSM (mamba1)
    ssm_state: int = 0
    d_inner: int = 0
    conv_kernel: int = 4
    dt_rank: int = 0             # 0 → ceil(d_model/16)

    # hybrid (recurrentgemma)
    layer_pattern: str = ""      # e.g. "rra" tiled over n_layers
    d_rnn: int = 0               # RG-LRU width

    # encoder-decoder (seamless)
    enc_layers: int = 0
    dec_layers: int = 0

    # embeddings / head
    tie_embeddings: bool = False
    emb_scale: bool = False      # multiply embeddings by sqrt(d_model)
    logit_softcap: float = 0.0

    # numerics / training
    dtype: str = "bfloat16"      # activations/params dtype for large-scale runs
    norm_eps: float = 1e-5

    # JAX-lowering and sharding knobs, kept so configs stay field-for-field
    # copies of the JAX package's; the port reads none of them
    unroll_layers: bool = False
    moe_local_groups: int = 0
    moe_combine: str = "gather"
    optimizer: str = "adamw"     # adamw | adafactor

    # ------------------------------------------------------------------ derived
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vhd(self) -> int:
        return self.v_head_dim or self.hd

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab, 2048)

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or (self.d_model + 15) // 16

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    @property
    def is_subquadratic(self) -> bool:
        """True if the arch can run long_500k (no full-attention layer)."""
        if self.family == "ssm":
            return True
        if self.family == "hybrid":
            return self.window > 0  # local attention is O(S·window)
        return False

    def pattern(self) -> str:
        """Per-layer kind string of length n_layers ('f'=full attn, 'l'=local,
        'r'=recurrent, 'm'=mamba)."""
        if self.family == "ssm":
            return "m" * self.n_layers
        if self.layer_pattern:
            reps = (self.n_layers + len(self.layer_pattern) - 1) // len(self.layer_pattern)
            return (self.layer_pattern * reps)[: self.n_layers]
        return ("l" if self.window else "f") * self.n_layers

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, v = self.d_model, self.padded_vocab
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        for kind in self.pattern():
            total += self._block_params(kind)
        if self.family == "encdec":
            # encoder blocks (full attn + ffn) — pattern above covered decoder
            total += self.enc_layers * self._block_params("f", cross=False)
            total += self.dec_layers * (self.d_model * self.hd * (self.n_heads + 2 * self.n_kv_heads)
                                        + self.n_heads * self.hd * self.d_model)  # cross-attn
        return total

    def _block_params(self, kind: str, cross: bool = False) -> int:
        d = self.d_model
        if kind == "m":
            di, r, s = self.d_inner, self.dt_rank_, self.ssm_state
            return (d * 2 * di + di * self.conv_kernel + di * (r + 2 * s)
                    + r * di + di * s + di + di * d)
        total = 0
        if kind in ("f", "l"):
            if self.use_mla:
                qd = self.q_lora or d
                total += d * self.q_lora if self.q_lora else 0
                total += qd * self.n_heads * (self.hd + self.rope_head_dim)
                total += d * (self.kv_lora + self.rope_head_dim)
                total += self.kv_lora * self.n_heads * (self.hd + self.vhd)
                total += self.n_heads * self.vhd * d
            else:
                total += d * self.hd * (self.n_heads + 2 * self.n_kv_heads)
                total += self.n_heads * self.vhd * d
        if kind == "r":
            dr = self.d_rnn
            total += d * dr * 2 + dr * 4 + dr * self.conv_kernel + dr * d  # in-projs, gates, conv, out
        # ffn
        total += self._ffn_params()
        return total

    def _ffn_params(self) -> int:
        d = self.d_model

        def dense_ffn(f):
            mult = 3 if self.act in ("swiglu", "geglu") else 2
            return mult * d * f
        if self.n_experts:
            per = dense_ffn(self.moe_d_ff)
            return (self.n_experts + self.n_shared_experts) * per + d * self.n_experts
        return dense_ffn(self.d_ff)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""

    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
