"""Shared set-up of the port-versus-JAX parity tests (no tests of its own):
a small charades-style MESM config, its JAX init, the same weights loaded
strictly into the port's torch model, and both forwards on one batch."""
from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mesm_tpu.models.mesm import MESM as JaxMESM
from mesm_tpu.models.mesm import MESMConfig as JaxConfig
from mesm_tpu_torch.convert import state_dict_from_jax_params
from mesm_tpu_torch.models.mesm import MESM as TorchMESM
from mesm_tpu_torch.models.mesm import MESMConfig as TorchConfig

from synth import make_batch, sample_neg_rows

# few layers, narrow widths; Lv >= 64 so the JAX Pallas attention engages
# under "on" (the DETR encoder sees Lv + 1 with the global token); Dv not a
# multiple of 16; B = 8 rows so the JAX short-key / short-query forms engage
SMALL = dict(
    hidden_dim=32, v_feat_dim=70, t_feat_dim=20, nheads=4, dim_feedforward=64,
    num_recfw_layers=1, t2v_layers=2, enc_layers=2, dec_layers=2, num_recss_layers=1,
    num_queries=5, max_words_l=8, max_video_l=64, num_classes=30,
)
B, LV, G = 8, 64, 3


def small_batch(seed: int = 0):
    return make_batch(np.random.default_rng(seed), B=B, Lv=LV, Dv=SMALL["v_feat_dim"],
                      Lw=SMALL["max_words_l"], Dt=SMALL["t_feat_dim"], G=G)


def jax_init(cfg: JaxConfig, batch) -> dict:
    model = JaxMESM(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    neg = jnp.asarray(sample_neg_rows(np.random.default_rng(1), batch["group_id"]))
    variables = model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "mask_words": jax.random.PRNGKey(2)},
        jb["video_feat"], jb["video_mask"], jb["words_feat"], jb["words_mask"],
        jb["sentence_feat"], neg,
        is_training=True, deterministic=True,
        clip_mask=jb["clip_mask"], words_weight=jb["words_weight"],
        unknown_mask=jb["unknown_mask"], ss_sent_idx=jb["ss_sent_idx"],
        ss_sent_mask=jb["ss_sent_mask"], ss_own_pos=jb["ss_own_pos"],
    )
    return jax.tree.map(np.asarray, variables["params"])


def build_pair(seed: int = 0, **overrides):
    """(jax config, jax params, torch model with the same weights, batch)."""
    kw = dict(SMALL, **overrides)
    jcfg = JaxConfig(**kw)
    batch = small_batch(seed)
    params = jax_init(jcfg, batch)
    tmodel = TorchMESM(TorchConfig(**kw))
    tmodel.load_state_dict(state_dict_from_jax_params(params, tmodel.cfg), strict=True)
    return jcfg, params, tmodel.eval(), batch


def _staged(batch, bf16: bool):
    """The eval feed's cast: float32 fields of ndim >= 3 go to bf16."""
    return {
        k: (np.asarray(v, np.float32).astype(jnp.bfloat16)
            if bf16 and np.asarray(v).dtype == np.float32 and np.asarray(v).ndim >= 3
            else np.asarray(v))
        for k, v in batch.items()
    }


def jax_forward(jcfg, params, batch, bf16: bool = False):
    """The JAX package's inference forward on the deduplicated-video route
    (bf16: compute dtype and staged features in bf16)."""
    if bf16:
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    jb = {k: jnp.asarray(v) for k, v in _staged(batch, bf16).items()}
    out = JaxMESM(jcfg).apply(
        {"params": params}, None, jb["video_mask"], jb["words_feat"], jb["words_mask"],
        jb["sentence_feat"], jnp.zeros((B,), jnp.int32),
        is_training=False, deterministic=True, compute_neg=False,
        video_feat_g=jb["video_feat_g"], video_mask_g=jb["video_mask_g"],
        video_slot=jb["video_slot"], ss_sent_idx=jb["ss_sent_idx"],
        ss_sent_mask=jb["ss_sent_mask"], ss_own_pos=jb["ss_own_pos"],
    )
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in out.items()}


def torch_forward(tmodel, batch, bf16: bool = False):
    t = {}
    for k, v in _staged(batch, bf16).items():
        t[k] = (torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
                if v.dtype == jnp.bfloat16 else torch.from_numpy(v))
    with torch.no_grad():
        out = tmodel(
            t["video_mask"], t["words_feat"], t["words_mask"], t["sentence_feat"],
            video_feat_g=t["video_feat_g"], video_mask_g=t["video_mask_g"],
            video_slot=t["video_slot"], ss_sent_idx=t["ss_sent_idx"],
            ss_sent_mask=t["ss_sent_mask"], ss_own_pos=t["ss_own_pos"],
        )
    return {k: v.float().numpy() for k, v in out.items()}


@contextlib.contextmanager
def jax_kernels(mode: str):
    """pallas_scope(mode) for the JAX package. Under "on" its CoreAttention
    sites pass split_qk=None on to fused_attention, which takes no such
    argument (mesm_tpu/models/attention.py:340); the shim drops the None so
    those sites reach the fallback fused_attention already has for them."""
    from mesm_tpu import kernels
    from mesm_tpu.ops import attention_pallas

    orig = attention_pallas.fused_attention

    def fused_attention(q, k, v, split_qk=None, **kwargs):
        assert split_qk is None
        return orig(q, k, v, **kwargs)

    attention_pallas.fused_attention = fused_attention
    try:
        with kernels.pallas_scope(mode):
            yield
    finally:
        attention_pallas.fused_attention = orig


# the training path at parity: attention and input dropout off, so the only
# random draws are the injected negatives and MLM masks
TRAIN = dict(SMALL, dropout=0.0, input_dropout=0.0)
# TACoS-style variant: the TwoMLP enhance encoder (share_MLP false)
TACOS = dict(TRAIN, share_mlp=False)


def train_batch(seed: int = 0):
    """small_batch with a padded last row (row_mask False) and MLM labels
    inside the small vocabulary."""
    batch = small_batch(seed)
    batch["row_mask"] = np.arange(B) < B - 1
    batch["words_label"] = batch["words_label"] % SMALL["num_classes"]
    return batch


def jax_train_forward(jcfg, params, batch, neg, mask_key: int = 2):
    """The JAX package's training forward (is_training, not deterministic):
    the stacked negative pass with `neg` and the MLM branch with masks drawn
    from PRNGKey(mask_key)."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return JaxMESM(jcfg).apply(
        {"params": params}, jb["video_feat"], jb["video_mask"], jb["words_feat"],
        jb["words_mask"], jb["sentence_feat"], jnp.asarray(neg),
        is_training=True, deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(1), "mask_words": jax.random.PRNGKey(mask_key)},
        clip_mask=jb["clip_mask"], words_weight=jb["words_weight"],
        unknown_mask=jb["unknown_mask"], ss_sent_idx=jb["ss_sent_idx"],
        ss_sent_mask=jb["ss_sent_mask"], ss_own_pos=jb["ss_own_pos"],
    )


def torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def torch_train_forward(tmodel, batch, neg, masked_words_loc):
    """The port's training forward (train mode) with injected negatives and
    MLM masks."""
    t = torch_batch(batch)
    tmodel.train()
    return tmodel(
        t["video_mask"], t["words_feat"], t["words_mask"], t["sentence_feat"],
        video_feat=t["video_feat"], ss_sent_idx=t["ss_sent_idx"], ss_sent_mask=t["ss_sent_mask"],
        ss_own_pos=t["ss_own_pos"], neg_idx_rows=torch.from_numpy(np.asarray(neg)),
        clip_mask=t["clip_mask"], words_weight=t["words_weight"], unknown_mask=t["unknown_mask"],
        masked_words_loc=torch.from_numpy(np.asarray(masked_words_loc)),
    )
