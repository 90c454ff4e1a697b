"""The port's training path against the JAX package's, on the CPU.

One JAX init of a small config (tests/test_torch_harness.py) is carried into
the port's model; both sides run fp32, JAX at matmul precision "highest",
torch without TF32. Attention and input dropout are 0 and the random draws
(out-of-group negatives, MLM word masks) are injected into the port from the
JAX side, so every number is comparable. Two config families: charades
(shared FFN, no triplet) and TACoS-style (the TwoMLP enhance encoder, the
saliency triplet term, TACoS's loss and matching weights).

Tolerances: module outputs, loss terms and gradients 1e-4 in units of
max(1, max |JAX|) (fp32 sums in another order through a dozen layers);
parameters after clip + AdamW 1e-6 abs against optax's chain on the same
gradients (the update is lr-sized, 2e-4).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mesm_tpu.losses import CriterionConfig as JaxCriterionConfig
from mesm_tpu.losses import compute_losses as jax_compute_losses
from mesm_tpu.ops.matcher import single_target_match as jax_single_target_match
from mesm_tpu.parallel.step import build_optimizer as jax_build_optimizer
from mesm_tpu_torch import kernels as tkernels
from mesm_tpu_torch.convert import state_dict_from_jax_params
from mesm_tpu_torch.losses import CriterionConfig, compute_losses
from mesm_tpu_torch.models.mesm import MESM as TorchMESM
from mesm_tpu_torch.models.mesm import MESMConfig as TorchConfig
from mesm_tpu_torch.models.mesm import gumbel_mask_words_choice
from mesm_tpu_torch.ops.matcher import single_target_match
from mesm_tpu_torch.parallel.step import (
    apply_update,
    build_optimizer,
    global_norm,
    make_micro_grads,
    make_train_step,
    sample_out_of_group,
    step_draws,
)

from synth import sample_neg_rows
from test_torch_harness import (
    TACOS,
    TRAIN,
    build_pair,
    jax_kernels,
    jax_train_forward,
    torch_batch,
    torch_train_forward,
    train_batch,
)

TOL = 1e-4
LR, WD, CLIP = 2e-4, 1e-4, 0.1
# criterion weights of the two families (config/charades/C+SF_C.json,
# config/TACoS/C3D_GloVe.json)
CRITERIA = {
    "charades": dict(span_coef=10.0, giou_coef=1.0, label_coef=4.0, saliency_coef=4.0,
                     recfw_coef=0.1, recss_coef=0.1, cost_class=4.0, rank_coef=12.0),
    "tacos": dict(span_coef=10.0, giou_coef=1.0, label_coef=6.0, saliency_coef=1.0,
                  recfw_coef=0.1, recss_coef=0.1, cost_class=6.0, rank_coef=1.0,
                  use_triplet=True),
}
MODELS = {"charades": TRAIN, "tacos": TACOS}


@pytest.fixture(autouse=True)
def grad_mode_on():
    """These tests take gradients; another module of the suite turns grad
    mode off for its whole process when it is imported
    (tests/test_transformer_oracle.py)."""
    with torch.enable_grad():
        yield


def _err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.size == 0:
        return 0.0
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.fixture(scope="module", params=["charades", "tacos"])
def family(request):
    """(name, jax config, jax params, torch model, batch, negatives, JAX
    training outputs) of one config family."""
    name = request.param
    with jax.default_matmul_precision("highest"):
        jcfg, params, tmodel, _ = build_pair(**MODELS[name])
        batch = train_batch()
        neg = sample_neg_rows(np.random.default_rng(1), batch["group_id"])
        jout = jax.tree.map(np.asarray, jax_train_forward(jcfg, params, batch, neg))
    return name, jcfg, params, tmodel, batch, neg, jout


def _encode(b):
    return b["words_feat"], b["words_mask"], b["sentence_feat"]


@pytest.mark.parametrize("cost_class", [4.0, 6.0])
def test_single_target_match_matches_jax(cost_class):
    rng = np.random.default_rng(0)
    B, nq = 16, 10
    logits = rng.normal(size=(B, nq, 2)).astype(np.float32)
    spans = np.stack([rng.uniform(0.1, 0.9, (B, nq)), rng.uniform(0.05, 0.5, (B, nq))], -1)
    spans = spans.astype(np.float32)
    spans[3, 4] = spans[3, 1]  # a tie: the first index wins, as jnp.argmin's
    logits[3, 4] = logits[3, 1]
    st = rng.uniform(0, 0.5, B)
    moment = np.stack([st, st + rng.uniform(0.1, 0.5, B)], -1).astype(np.float32)
    span = np.stack([moment.mean(-1), moment[:, 1] - moment[:, 0]], -1).astype(np.float32)
    want = jax_single_target_match(*(jnp.asarray(a) for a in (logits, spans, span, moment)),
                                   10.0, 1.0, cost_class)
    got = single_target_match(*(torch.from_numpy(a) for a in (logits, spans, span, moment)),
                              10.0, 1.0, cost_class)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_compute_losses_match_jax(family):
    """Every loss term of both criteria on the same predictions (the JAX
    training forward's outputs)."""
    name, _, _, _, batch, _, jout = family
    kw = CRITERIA[name]
    want, want_total = jax_compute_losses(
        {k: jnp.asarray(v) for k, v in jout.items()}, {k: jnp.asarray(v) for k, v in batch.items()},
        JaxCriterionConfig(**kw), is_training=True,
    )
    got, got_total = compute_losses(
        {k: torch.from_numpy(np.asarray(v)) for k, v in jout.items()}, torch_batch(batch),
        CriterionConfig(**kw), is_training=True,
    )
    assert set(got) == set(want)
    for key in want:
        assert _err(_np(got[key]), want[key]) <= TOL, key
    assert _err(_np(got_total), want_total) <= TOL


@pytest.mark.parametrize("mode", ["off", "on"])
def test_training_forward_matches_jax(family, mode):
    """The training forward (stacked negative pass, second SS projection,
    MLM branch) with the JAX side's negatives and MLM masks. Under "on" the
    DETR encoder's self-attention runs the trainable Function on both sides
    (JAX: the batched Pallas kernel in interpret mode)."""
    name, jcfg, params, tmodel, batch, neg, jout = family
    if mode == "on":
        with jax.default_matmul_precision("highest"), jax_kernels("on"):
            jout = jax.tree.map(np.asarray, jax_train_forward(jcfg, params, batch, neg))
    with tkernels.pallas_scope(mode):
        got = torch_train_forward(tmodel, batch, neg, jout["masked_words_loc"])
    assert set(got) == set(jout)
    for key, want in jout.items():
        assert got[key].shape == want.shape, key
        assert _err(_np(got[key]), want) <= TOL, key


_LOSS_AND_GRADS = {}  # one compiled JAX value_and_grad per family


def _jax_loss_and_grads(name, jcfg, params, batch, neg):
    if name not in _LOSS_AND_GRADS:
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        ccfg = JaxCriterionConfig(**CRITERIA[name])

        def loss_fn(p):
            out = jax_train_forward(jcfg, p, batch, neg)
            losses, total = jax_compute_losses(out, jb, ccfg, is_training=True)
            return total, losses

        _LOSS_AND_GRADS[name] = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    with jax.default_matmul_precision("highest"):
        return _LOSS_AND_GRADS[name](params)


def _torch_grads_like_jax(jgrads, jcfg, tmodel):
    """The JAX gradient tree in the port's state-dict names. The TwoMLP
    layers of the reference share one PReLU slope between their two FFNs
    (the port too), where the JAX package keeps two: the shared slope's
    gradient is the sum of both."""
    sd = state_dict_from_jax_params(jax.tree.map(np.asarray, jgrads), tmodel.cfg)
    if not jcfg.share_mlp:
        for i in range(jcfg.num_recfw_layers):
            extra = np.asarray(jgrads["enhance_encoder"][f"layer{i}"]["ffn_mlm"]["PReLU_0"]["alpha"])
            sd[f"enhance_encoder.t2v_encoder.layers.{i}.activation.weight"] += torch.from_numpy(extra)
    return sd


def _fresh_copy(tmodel):
    model = type(tmodel)(tmodel.cfg)
    model.load_state_dict(tmodel.state_dict())
    return model


def test_train_step_loss_and_grads_match_jax(family):
    """One micro-batch from the shared converted init: the loss, every loss
    term and every parameter gradient."""
    name, jcfg, params, tmodel, batch, neg, jout = family
    (want_total, want_losses), jgrads = _jax_loss_and_grads(name, jcfg, params, batch, neg)
    model = _fresh_copy(tmodel)
    micro = make_micro_grads(model, CriterionConfig(**CRITERIA[name]), _encode)
    total, losses = micro(torch_batch(batch), neg_idx_rows=torch.from_numpy(neg),
                             masked_words_loc=torch.from_numpy(jout["masked_words_loc"]))
    assert _err(_np(total), want_total) <= TOL
    for key, want in want_losses.items():
        assert _err(_np(losses[key]), want) <= TOL, key
    want_grads = _torch_grads_like_jax(jgrads, jcfg, model)
    params_t = dict(model.named_parameters())
    assert set(want_grads) == set(params_t)
    for key, want in want_grads.items():
        # a parameter the loss never reads (the SS output projection) has
        # no gradient here and a zero one in JAX
        grad = params_t[key].grad
        grad = torch.zeros_like(params_t[key]) if grad is None else grad
        assert _err(_np(grad), want.numpy()) <= TOL, key


def test_clip_and_adamw_match_optax(family):
    """The port's clip + AdamW against optax's chain (mesm_tpu
    build_optimizer) on the same parameters and gradients, over two updates
    (the clip engages: the gradients' norm is above 0.1), and once more with
    gradients under the clip norm."""
    name, _, _, tmodel, batch, neg, jout = family
    model = _fresh_copy(tmodel)
    micro = make_micro_grads(model, CriterionConfig(**CRITERIA[name]), _encode)
    micro(torch_batch(batch), neg_idx_rows=torch.from_numpy(neg),
          masked_words_loc=torch.from_numpy(jout["masked_words_loc"]))
    names = [n for n, _ in model.named_parameters()]
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
             for n, p in model.named_parameters()}
    assert float(global_norm(grads.values())) > CLIP
    tx = jax_build_optimizer(lr=LR, weight_decay=WD, grad_clip=CLIP)
    jparams = {n: jnp.asarray(p.detach().numpy()) for n, p in model.named_parameters()}
    opt_state = tx.init(jparams)
    optimizer = build_optimizer(model, LR, WD)
    for scale in (1.0, 0.5, 1e-3):
        jgrads = {n: jnp.asarray(grads[n].numpy() * scale) for n in names}
        updates, opt_state = tx.update(jgrads, opt_state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        for n, p in model.named_parameters():
            p.grad = grads[n] * scale
        norm = apply_update(optimizer, CLIP)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(jgrads)), rtol=1e-6)
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[n]), atol=1e-6,
                                       rtol=0, err_msg=n)


def test_three_step_loss_trajectory_matches_jax(family):
    """Three full train steps (forward, losses, backward, clip, AdamW) from
    the shared init, the same negatives and MLM masks at every step."""
    name, jcfg, params, tmodel, batch, neg, jout = family
    tx = jax_build_optimizer(lr=LR, weight_decay=WD, grad_clip=CLIP)
    opt_state = tx.init(params)
    want = []
    p = params
    for _ in range(3):
        (total, _), g = _jax_loss_and_grads(name, jcfg, p, batch, neg)
        want.append(float(total))
        updates, opt_state = tx.update(g, opt_state, p)
        p = jax.tree.map(lambda a, u: a + u, p, updates)
    model = _fresh_copy(tmodel)
    optimizer = build_optimizer(model, LR, WD)
    step = make_train_step(model, CriterionConfig(**CRITERIA[name]), _encode, optimizer, CLIP, seed=0)
    tb = torch_batch(batch)
    got = [float(step(tb, i, neg_idx_rows=torch.from_numpy(neg),
                      masked_words_loc=torch.from_numpy(jout["masked_words_loc"]))["loss_overall"])
           for i in range(3)]
    for a, b in zip(got, want):
        assert abs(a - b) <= TOL * max(1.0, abs(b)), (got, want)
    assert got[2] < got[0]


def test_gumbel_mask_words_choice_counts():
    """max(l // 3, 1) weighted positions per row among the eligible words,
    none for rows of at most one word; one generator seed, one draw."""
    rng = np.random.default_rng(0)
    B, L = 64, 12
    lengths = rng.integers(0, L + 1, B)
    mask = torch.from_numpy(np.arange(L)[None] < lengths[:, None])
    weight = torch.from_numpy(rng.integers(1, 3, (B, L)).astype(np.float32)) * mask
    draw = [gumbel_mask_words_choice(mask, weight, torch.Generator().manual_seed(s)) for s in (5, 5, 6)]
    assert torch.equal(draw[0], draw[1]) and not torch.equal(draw[0], draw[2])
    chosen = draw[0]
    assert not (chosen & ~mask).any()
    want = np.where(lengths > 1, np.maximum(lengths // 3, 1), 0)
    np.testing.assert_array_equal(chosen.sum(1).numpy(), want)


def test_sample_out_of_group_and_step_draws():
    """Every row gets a valid row of another group (the fallback (i+1) % B
    where there is none), and a step's draws depend on (seed, step) only."""
    group = torch.tensor([0, 0, 1, 1, 1, 2, 2, 2])
    row_mask = torch.tensor([1, 1, 1, 1, 1, 1, 1, 0])
    for s in range(20):
        idx = sample_out_of_group(torch.Generator().manual_seed(s), group, row_mask)
        assert (group[idx] != group).all() and (row_mask[idx] > 0).all()
    same = torch.zeros(4, dtype=torch.long)
    np.testing.assert_array_equal(
        sample_out_of_group(torch.Generator().manual_seed(0), same).numpy(), [1, 2, 3, 0]
    )
    a, b, c = (step_draws(7, st, "cpu") for st in (3, 3, 4))
    assert torch.equal(torch.rand(5, generator=a[0]), torch.rand(5, generator=b[0]))
    assert torch.equal(torch.rand(5, generator=a[1]), torch.rand(5, generator=b[1]))
    assert not torch.equal(torch.rand(5, generator=a[0]), torch.rand(5, generator=c[0]))


def test_train_step_repeats_its_draws_with_dropout():
    """With dropout on and nothing injected, two models from one init take
    the same step at the same (seed, step): negatives, MLM masks and dropout
    masks are drawn again, which is what a resumed run relies on."""
    torch.manual_seed(0)
    tmodel = TorchMESM(TorchConfig(**dict(TRAIN, dropout=0.1, input_dropout=0.5)))
    batch = torch_batch(train_batch())
    ccfg = CriterionConfig(**CRITERIA["charades"])
    runs = []
    for _ in range(2):
        model = _fresh_copy(tmodel)
        step = make_train_step(model, ccfg, _encode, build_optimizer(model, LR, WD), CLIP, seed=3)
        runs.append([float(step(batch, st)["loss_overall"]) for st in (10, 11)])
    assert runs[0] == runs[1]
    assert runs[0][0] != runs[0][1]


def test_bf16_trainable_route_in_the_model_keeps_gradients():
    """bf16 training through the dispatch (packed kernel's plain version in
    the Function's forward under "on"): every parameter gets a finite
    gradient."""
    torch.manual_seed(0)
    model = TorchMESM(TorchConfig(**TRAIN))
    batch = torch_batch(train_batch())
    neg = torch.from_numpy(sample_neg_rows(np.random.default_rng(1), batch["group_id"].numpy()))
    micro = make_micro_grads(model, CriterionConfig(**CRITERIA["charades"]), _encode, torch.bfloat16)
    with tkernels.pallas_scope("on"):
        total, _ = micro(batch, torch.Generator(), torch.Generator().manual_seed(1), neg)
    assert torch.isfinite(total)
    for n, p in model.named_parameters():
        if not n.startswith("ss_reconstructor.output_sent_proj"):  # no loss reads it
            assert p.grad is not None and torch.isfinite(p.grad).all(), n


def test_multi_clip_losses_wait_for_the_qvh_slice(family):
    """The multi-clip criterion (ported with the QVHighlights slice) on the
    family's batch with each row's one target as a one-window multi-clip
    target: every term equals the JAX package's multi-clip terms, and the
    Hungarian-matched span, gIoU and label terms equal the single-target
    terms (a one-row assignment is the cost argmin)."""
    name, _, _, _, batch, _, jout = family
    multi = dict(batch, norm_span=batch["norm_span"][:, None], norm_moment=batch["norm_moment"][:, None],
                 tgt_mask=np.ones((len(batch["group_id"]), 1), bool))
    kw = dict(CRITERIA[name], multi_clip=True)
    want, want_total = jax_compute_losses(
        {k: jnp.asarray(v) for k, v in jout.items()}, {k: jnp.asarray(v) for k, v in multi.items()},
        JaxCriterionConfig(**kw), is_training=True,
    )
    outputs = {k: torch.from_numpy(np.asarray(v)) for k, v in jout.items()}
    got, got_total = compute_losses(outputs, torch_batch(multi), CriterionConfig(**kw))
    assert set(got) == set(want)
    for key in want:
        assert _err(_np(got[key]), want[key]) <= TOL, key
    assert _err(_np(got_total), want_total) <= TOL
    single, _ = compute_losses(outputs, torch_batch(batch), CriterionConfig(**CRITERIA[name]))
    for key in ("loss_span", "loss_giou", "loss_label", "loss_span_0", "loss_rec_ss"):
        assert _err(_np(got[key]), _np(single[key])) <= TOL, key
