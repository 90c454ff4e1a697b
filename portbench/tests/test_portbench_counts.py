"""The count functions against torch's own count of the matrix products
(torch.utils.flop_counter.FlopCounterMode) on the reference at a small
size, every row whole (no padding, so the model lays out each row at its
own lengths); and the kernels' work at hand-computed sizes."""
from dataclasses import asdict

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.counts import kernels, model as M
from portbench.reference.model import MESM, model_config
from portbench.reference.train import losses
from portbench.tests.tiny import TINY_CONFIG
from portbench.weights import fill_from_seed

from portbench import harness


def _whole_batch(cfg: dict, B=4, L=12, seed=0):
    """B rows, two videos of B / 2 rows each, every clip, word and group
    member valid."""
    g = torch.Generator().manual_seed(seed)
    Dv, Dt, Lw = cfg["v_feat_dim"] + 2, cfg["t_feat_dim"], cfg["max_words_l"]
    G = B // 2
    group = torch.arange(B) // G
    idx = torch.stack([torch.arange(G) + G * int(group[r]) for r in range(B)])
    b = {
        "video_feat": torch.randn(B, L, Dv, generator=g),
        "video_mask": torch.ones(B, L, dtype=torch.bool),
        "cached_words_feat": torch.randn(B, Lw, Dt, generator=g),
        "cached_words_mask": torch.ones(B, Lw, dtype=torch.bool),
        "cached_sentence_feat": torch.randn(B, Dt, generator=g),
        "ss_sent_idx": idx, "ss_sent_mask": torch.ones(B, G, dtype=torch.bool),
        "ss_own_pos": torch.arange(B) % G, "group_id": group,
        "row_mask": torch.ones(B, dtype=torch.bool),
        "clip_mask": torch.zeros(B, L, dtype=torch.bool),
        "words_weight": torch.ones(B, Lw), "unknown_mask": torch.zeros(B, Lw, dtype=torch.bool),
        "words_label": torch.randint(0, 10, (B, Lw), generator=g),
        "norm_moment": torch.tensor([[0.2, 0.5]] * B), "norm_span": torch.tensor([[0.35, 0.3]] * B),
        "pos_idx": torch.tensor([[3, 4]] * B), "neg_idx": torch.tensor([[0, 9]] * B),
    }
    b["clip_mask"][:, 3:6] = True
    return b


@pytest.fixture(scope="module")
def setup():
    cfg = dict(harness.load("configs", "tacos-c3d-glove")["config"], **TINY_CONFIG)
    cfg["max_words_l"] = 5
    ref = MESM(model_config(cfg))
    fill_from_seed(ref, 3)
    return cfg, ref, asdict(model_config(cfg))


def test_eval_forward_count(setup):
    cfg, ref, c = setup
    b = _whole_batch(cfg)
    ref.eval()
    ref.requires_grad_(False)
    with FlopCounterMode(display=False) as fc:
        ref(b)
    ref.requires_grad_(True)
    np_b = {k: v.numpy() for k, v in b.items()}
    assert M.eval_batch(c, np_b) == pytest.approx(fc.get_total_flops(), rel=1e-12)


def test_train_step_count(setup):
    cfg, ref, c = setup
    b = _whole_batch(cfg, seed=1)
    neg = torch.tensor([2, 3, 0, 1])
    u = torch.rand(b["cached_words_mask"].shape, generator=torch.Generator().manual_seed(5))
    ref.train()
    with FlopCounterMode(display=False) as fc:
        _, total = losses(ref(b, neg_rows=neg, mlm_u=u), b, cfg)
        total.backward()
    np_b = {k: v.numpy() for k, v in b.items()}
    got = M.train_batch(c, np_b, neg_rows=neg.numpy())
    # the backward counted as two products a forward product: the few whose
    # input takes no gradient are a few % at this width (d = 32), less at 256
    assert got == pytest.approx(fc.get_total_flops(), rel=0.03)
    assert got >= fc.get_total_flops()


def test_kernel_work():
    ops, nbytes = kernels.ln_dense(600, 4098, 256)
    assert ops == 2 * 600 * 4098 * 256
    assert nbytes == 4 * (600 * 4098 + 256 * 4098 + 600 * 256) + 4 * (2 * 4098 + 256)
    lq = lk = np.array([601, 301])
    ops, nbytes = kernels.attention_forward(lq, lk, 256)
    assert ops == 4 * (601 * 601 + 301 * 301) * 256
    ops_b, _ = kernels.attention_backward(lq, lk, 256)
    assert ops_b == 2.5 * ops
    # the least time is the larger bound
    assert kernels.roofline_seconds(1e12, 1e9, 1e15, 1e12) == pytest.approx(1e-3)
