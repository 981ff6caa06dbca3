"""Architecture config schema (pair: ``repro/configs/base.py:1``).

Verbatim copy of ``ArchConfig`` except ``param_count`` and
``active_param_count``, which read the port's analytic count
(``models/model.py::count_params_analytic``, shapes of ``init`` on the meta
device) in place of ``jax.eval_shape``. ``InputShape`` and the serving
input shapes come with the serving path.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    """Static architecture description.

    ``family`` selects the forward implementation:
      dense | moe | ssm | hybrid | encdec (audio) | vlm
    (the port runs ``dense`` so far).
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    source: str = ""

    # --- attention ---
    head_dim: int = 0            # 0 -> d_model // n_heads
    window: int = 0              # NATIVE sliding window (hymba); 0 = full attention
    serve_window: int = 0        # ring-buffer window for the long-context serve
                                 # variant (long_500k); 0 = full cache
    rope_theta: float = 10_000.0

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_shared: int = 0         # shared-expert FFN width (0 -> d_ff * n_shared)
    capacity_factor: float = 1.25

    # --- SSM / hybrid ---
    ssm_state: int = 0
    slstm_every: int = 0         # xLSTM: every Nth block is sLSTM (0 = none)
    d_conv: int = 4              # mamba-style depthwise conv width

    # --- enc-dec / frontends ---
    n_enc_layers: int = 0
    frontend: str = "none"       # none | audio | vision
    n_frontend_tokens: int = 0   # patch / frame count provided by the stub frontend
    d_frontend: int = 0          # stub embedding dim (0 -> d_model)

    # --- misc ---
    pad_vocab_multiple: int = 0  # pad embed/head rows so vocab shards evenly
                                 # (Megatron-style; padded logits masked)
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"      # activation/compute dtype
    param_dtype: str = "float32"

    # --- DTFL tiering ---
    n_modules: int = 8           # paper: 8 modules (md1..md8); tiers split on these

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_multiple
        if not m:
            return self.vocab
        return ((self.vocab + m - 1) // m) * m

    @property
    def d_ff_shared_resolved(self) -> int:
        if self.n_shared_experts == 0:
            return 0
        return self.d_ff_shared or self.d_ff * self.n_shared_experts

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """CPU smoke variant: same family/topology, tiny sizes."""
        d = min(self.d_model, 128)
        heads = min(self.n_heads, 4)
        kv = min(self.n_kv_heads, heads)
        # keep head ratio divisible
        while heads % kv:
            kv -= 1
        upd = dict(
            n_layers=2,
            d_model=d,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=d // heads,
            d_ff=min(self.d_ff, 4 * d) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            n_modules=2,
            window=min(self.window, 64) if self.window else 0,
            serve_window=min(self.serve_window, 64) if self.serve_window else 0,
        )
        if self.n_experts:
            upd.update(
                n_experts=min(self.n_experts, 4),
                top_k=min(self.top_k, 2),
                d_ff=min(self.d_ff, 2 * d),
                d_ff_shared=min(self.d_ff_shared_resolved, 2 * d),
            )
        if self.ssm_state:
            upd["ssm_state"] = min(self.ssm_state, 8)
        if self.n_enc_layers:
            upd["n_enc_layers"] = 2
        if self.n_frontend_tokens:
            upd["n_frontend_tokens"] = min(self.n_frontend_tokens, 16)
            upd["d_frontend"] = min(self.d_frontend or self.d_model, d)
        return self.replace(**upd)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (matches init exactly; tested)."""
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self, active_only=True)
