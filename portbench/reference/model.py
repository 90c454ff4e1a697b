"""The plain reference of MESM: its eval and training forward in plain
PyTorch, with the upstream torch state-dict names.

It follows the published model (lntzm/MESM, model/model.py,
model/transformer.py, model/attention.py, model/position_encoding.py) as
the measured program states it: post-norm T2V layers whose cross-attention
pair mask is tiled head-major and read batch-major (head h of sample b takes
the pairs of sample (b * H + h) % B), a DETR encoder with a prepended global
token that is a query and never a key, a DAB decoder whose cross-attention
adds the positional dot product to the content one, sine positions over the
valid clips. Every attention is the same plain core: scaled QK^T, -1e9 at
the masked keys, softmax in float32. There are no kernels, no caches of
derived weights, no coalescing and no CUDA graphs: each batch is one call,
each row's video projected with it.

Nothing here imports the measured program. Dropout is left out: the
configurations run it at rate 0 in training, and eval has none.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -1e9


@dataclass(frozen=True)
class ModelConfig:
    hidden_dim: int
    v_feat_dim: int  # with the 2 TEF channels
    t_feat_dim: int
    nheads: int
    dim_feedforward: int
    num_recfw_layers: int
    t2v_layers: int
    enc_layers: int
    dec_layers: int
    num_recss_layers: int
    num_queries: int
    n_input_proj: int
    rec_fw: bool
    rec_ss: bool
    share_mlp: bool
    aux_loss: bool
    num_classes: int


def model_config(opt: dict) -> ModelConfig:
    """The model's sizes from a benchmark configuration's `config` (the
    shipped keys; v_feat_dim gains the 2 TEF channels when use_tef)."""
    vocab = opt["vocab_size"]
    return ModelConfig(
        hidden_dim=opt["hidden_dim"],
        v_feat_dim=opt["v_feat_dim"] + (2 if opt.get("use_tef") else 0),
        t_feat_dim=opt["t_feat_dim"], nheads=opt["nheads"],
        dim_feedforward=opt["dim_feedforward"], num_recfw_layers=opt["num_recfw_layers"],
        t2v_layers=opt["t2v_layers"], enc_layers=opt["enc_layers"],
        dec_layers=opt["dec_layers"], num_recss_layers=opt["num_recss_layers"],
        num_queries=opt["num_queries"], n_input_proj=opt["n_input_proj"],
        rec_fw=bool(opt["rec_fw"]), rec_ss=bool(opt["rec_ss"]),
        share_mlp=bool(opt["share_MLP"]), aux_loss=bool(opt["aux_loss"]),
        num_classes=vocab + 3 if opt["tokenizer_type"] == "CLIP" else vocab + 1,
    )


# -- building blocks ----------------------------------------------------------


def layer_norm(x, mod):
    return F.layer_norm(x, mod.normalized_shape, mod.weight, mod.bias, mod.eps)


class LinearBlock(nn.Module):
    """LayerNorm -> Linear -> [ReLU] (upstream LinearLayer)."""

    def __init__(self, i: int, o: int, relu: bool):
        super().__init__()
        self.LayerNorm = nn.LayerNorm(i, eps=1e-5)
        self.net = nn.Sequential(nn.Dropout(0.0), nn.Linear(i, o))
        self.relu = relu

    def forward(self, x):
        x = self.net[1](layer_norm(x, self.LayerNorm))
        return F.relu(x) if self.relu else x


class InputProj(nn.ModuleList):
    def __init__(self, i: int, d: int, n: int):
        flags = [True, True, True]
        flags[n - 1] = False
        super().__init__(LinearBlock(i if j == 0 else d, d, flags[j]) for j in range(n))

    def forward(self, x):
        for blk in self:
            x = blk(x)
        return x


class MLP(nn.Module):
    def __init__(self, i: int, h: int, o: int, n: int):
        super().__init__()
        dims = [h] * (n - 1)
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip([i] + dims, dims + [o]))

    def forward(self, x):
        for j, layer in enumerate(self.layers):
            x = layer(x)
            if j < len(self.layers) - 1:
                x = F.relu(x)
        return x


def prelu(x, act):
    return F.prelu(x, act.weight)


def attention(q, k, v, H, key_valid=None, pair=None, split=None):
    """Multi-head attention before the out-projection. q (B, Lq, E), k (B,
    Lk, E), v (B, Lk, Ev); key_valid (B, Lk) True = attendable; pair =
    (qf (B, H, Lq), kf (B, H, Lk)): a pair is masked where both flag it;
    split = (q2, k2): a second dot product added to the logits, the scale
    taken over both widths."""
    B, Lq, E = q.shape
    Lk, Ev = k.shape[1], v.shape[-1]
    E_total = E + (split[0].shape[-1] if split is not None else 0)
    scale = (E_total // H) ** -0.5
    qh = q.reshape(B, Lq, H, -1).transpose(1, 2)
    kh = k.reshape(B, Lk, H, -1).transpose(1, 2)
    vh = v.reshape(B, Lk, H, -1).transpose(1, 2)
    logits = torch.matmul(qh * scale, kh.transpose(-1, -2))
    if split is not None:
        q2h = split[0].reshape(B, Lq, H, -1).transpose(1, 2)
        k2h = split[1].reshape(B, Lk, H, -1).transpose(1, 2)
        logits = logits + torch.matmul(q2h * scale, k2h.transpose(-1, -2))
    if pair is not None:
        logits = logits.masked_fill(pair[0][..., :, None] & pair[1][..., None, :], NEG_INF)
    if key_valid is not None:
        logits = logits.masked_fill(~key_valid[:, None, None, :].bool(), NEG_INF)
    w = torch.softmax(logits.float(), dim=-1)
    return torch.matmul(w, vh).transpose(1, 2).reshape(B, Lq, Ev)


class ProjAttention(nn.Module):
    """nn.MultiheadAttention's parameters (packed in_proj + out_proj)."""

    def __init__(self, d: int, H: int):
        super().__init__()
        self.H = H
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d))
        self.out_proj = nn.Linear(d, d)

    def forward(self, q, k, v, key_valid=None, pair=None):
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        out = attention(F.linear(q, wq, bq), F.linear(k, wk, bk), F.linear(v, wv, bv), self.H,
                        key_valid, pair)
        return self.out_proj(out)


class CoreAttention(nn.Module):
    def __init__(self, d: int, H: int):
        super().__init__()
        self.H = H
        self.out_proj = nn.Linear(d, d)

    def forward(self, q, k, v, key_valid=None, split=None):
        return self.out_proj(attention(q, k, v, self.H, key_valid, split=split))


def pair_factors(vid_valid, txt_valid, H):
    """The upstream pair mask's factors: head h of sample b takes sample
    (b * H + h) % B's padding."""
    qpad, kpad = ~vid_valid.bool(), ~txt_valid.bool()
    B = qpad.shape[0]
    src = (torch.arange(B, device=qpad.device)[:, None] * H
           + torch.arange(H, device=qpad.device)[None, :]) % B
    return qpad[src], kpad[src]


def sine_positions(mask, d):
    """Sine positions over the valid count, normalised to [0, 2 pi];
    channel 2k is sin, 2k+1 cos of x / 10000^(2k / d)."""
    x = torch.cumsum(mask.float(), dim=1)
    x = x / (x[:, -1:] + 1e-6) * (2 * math.pi)
    i = torch.arange(d // 2, dtype=torch.float32, device=mask.device)
    angle = x[..., None] / (10000.0 ** (2.0 * i / d))
    return torch.stack([torch.sin(angle), torch.cos(angle)], -1).reshape(*mask.shape, d)


def l2n(x, eps=1e-12):
    return x / torch.sqrt((x * x).sum(-1, keepdim=True)).clamp(min=eps)


# -- T2V ----------------------------------------------------------------------


class T2VLayer(nn.Module):
    def __init__(self, d, H, Fd, two_mlp):
        super().__init__()
        self.H, self.two_mlp = H, two_mlp
        self.self_attn = ProjAttention(d, H)
        self.linear1, self.linear2 = nn.Linear(d, Fd), nn.Linear(Fd, d)
        self.norm1, self.norm2 = nn.LayerNorm(d, eps=1e-5), nn.LayerNorm(d, eps=1e-5)
        if two_mlp:
            self.linear1_1, self.linear2_1 = nn.Linear(d, Fd), nn.Linear(Fd, d)
            self.norm1_1, self.norm2_1 = nn.LayerNorm(d, eps=1e-5), nn.LayerNorm(d, eps=1e-5)
        self.activation = nn.PReLU()

    def forward(self, txt, vid, txt_valid, pos_txt, pos_vid, vid_valid, is_mlm=False, pair=None):
        q = vid if pos_vid is None else vid + pos_vid
        k = txt if pos_txt is None else txt + pos_txt
        if pair is None and vid_valid is not None:
            pair = pair_factors(vid_valid, txt_valid, self.H)
        x = vid + self.self_attn(q, k, txt, txt_valid, pair)
        if self.two_mlp and is_mlm:
            n1, l1, l2, n2 = self.norm1_1, self.linear1_1, self.linear2_1, self.norm2_1
        else:
            n1, l1, l2, n2 = self.norm1, self.linear1, self.linear2, self.norm2
        y = l2(prelu(l1(layer_norm(x, n1)), self.activation))
        return layer_norm(x + y, n2)


class T2VStack(nn.Module):
    def __init__(self, d, H, n, Fd, two_mlp=False):
        super().__init__()
        self.layers = nn.ModuleList(T2VLayer(d, H, Fd, two_mlp) for _ in range(n))

    def forward(self, txt, vid, txt_valid, pos_txt=None, pos_vid=None, vid_valid=None,
                is_mlm=False, pair=None):
        for layer in self.layers:
            vid = layer(txt, vid, txt_valid, pos_txt, pos_vid, vid_valid, is_mlm, pair)
        return vid


class T2VEncoder(nn.Module):
    def __init__(self, *a, **kw):
        super().__init__()
        self.t2v_encoder = T2VStack(*a, **kw)

    def forward(self, *a, **kw):
        return self.t2v_encoder(*a, **kw)


# -- DETR ---------------------------------------------------------------------


def inverse_sigmoid(x, eps=1e-3):
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def anchor_sine(pos, d):
    """(B, nq, 2) anchors -> (B, nq, d): each coordinate over d / 2 channels."""
    half = d // 2
    i = torch.arange(half, dtype=torch.float32, device=pos.device)
    dim_t = 10000.0 ** (2 * torch.floor(i / 2) / half)

    def embed(c):
        x = c[..., None] * (2 * math.pi) / dim_t
        return torch.stack([torch.sin(x[..., 0::2]), torch.cos(x[..., 1::2])], -1).flatten(-2)

    return torch.cat([embed(pos[..., 0]), embed(pos[..., 1])], -1)


class EncoderLayer(nn.Module):
    def __init__(self, d, H, Fd):
        super().__init__()
        self.self_attn = ProjAttention(d, H)
        self.linear1, self.linear2 = nn.Linear(d, Fd), nn.Linear(Fd, d)
        self.norm1, self.norm2 = nn.LayerNorm(d, eps=1e-5), nn.LayerNorm(d, eps=1e-5)
        self.activation = nn.PReLU()

    def forward(self, src, valid, pos):
        q = src + pos
        src = layer_norm(src + self.self_attn(q, q, src, valid), self.norm1)
        y = self.linear2(prelu(self.linear1(src), self.activation))
        return layer_norm(src + y, self.norm2)


class DecoderLayer(nn.Module):
    NAMES = ("sa_qcontent_proj", "sa_qpos_proj", "sa_kcontent_proj", "sa_kpos_proj",
             "sa_v_proj", "ca_qcontent_proj", "ca_kcontent_proj", "ca_v_proj", "ca_kpos_proj",
             "ca_qpos_sine_proj")

    def __init__(self, d, H, Fd, first):
        super().__init__()
        for n in self.NAMES:
            setattr(self, n, nn.Linear(d, d))
        self.first = first
        if first:
            self.ca_qpos_proj = nn.Linear(d, d)
        self.self_attn, self.cross_attn = CoreAttention(d, H), CoreAttention(d, H)
        self.linear1, self.linear2 = nn.Linear(d, Fd), nn.Linear(Fd, d)
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(d, eps=1e-5) for _ in range(3))
        self.activation = nn.PReLU()

    def forward(self, tgt, memory, mem_valid, pos, query_pos, qse):
        q = self.sa_qcontent_proj(tgt) + self.sa_qpos_proj(query_pos)
        k = self.sa_kcontent_proj(tgt) + self.sa_kpos_proj(query_pos)
        tgt = layer_norm(tgt + self.self_attn(q, k, self.sa_v_proj(tgt)), self.norm1)
        qc, kc, v = self.ca_qcontent_proj(tgt), self.ca_kcontent_proj(memory), self.ca_v_proj(memory)
        kp = self.ca_kpos_proj(pos)
        if self.first:
            qc, kc = qc + self.ca_qpos_proj(query_pos), kc + kp
        ca = self.cross_attn(qc, kc, v, mem_valid, split=(self.ca_qpos_sine_proj(qse), kp))
        tgt = layer_norm(tgt + ca, self.norm2)
        y = self.linear2(prelu(self.linear1(tgt), self.activation))
        return layer_norm(tgt + y, self.norm3)


class Decoder(nn.Module):
    def __init__(self, d, H, n, Fd):
        super().__init__()
        self.d = d
        self.layers = nn.ModuleList(DecoderLayer(d, H, Fd, i == 0) for i in range(n))
        self.ref_point_head = MLP(d, d, d, 2)
        self.query_scale = MLP(d, d, d, 2)
        self.bbox_embed = MLP(d, d, 2, 3)
        self.ref_anchor_head = MLP(d, d, 1, 2)
        self.norm = nn.LayerNorm(d, eps=1e-5)

    def forward(self, tgt, memory, mem_valid, pos, refpoints):
        out, ref = tgt, torch.sigmoid(refpoints)
        refs, hidden = [ref], []
        for i, layer in enumerate(self.layers):
            qse = anchor_sine(ref, self.d)
            query_pos = self.ref_point_head(qse)
            if i != 0:
                qse = qse * self.query_scale(out)
            cond = torch.sigmoid(self.ref_anchor_head(out))
            qse = qse * (cond[..., 0] / ref[..., 1])[..., None]
            out = layer(out, memory, mem_valid, pos, query_pos, qse)
            new_ref = torch.sigmoid(self.bbox_embed(out) + inverse_sigmoid(ref))
            if i != len(self.layers) - 1:
                refs.append(new_ref)
            ref = new_ref.detach()
            hidden.append(layer_norm(out, self.norm))
        return torch.stack(hidden), torch.stack(refs)


class Transformer(nn.Module):
    def __init__(self, d, H, n_enc, n_dec, Fd):
        super().__init__()
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(EncoderLayer(d, H, Fd) for _ in range(n_enc))
        self.decoder = Decoder(d, H, n_dec, Fd)

    def forward(self, src, valid, query_embed, pos, gtok, gpos):
        B, L, d = src.shape
        src, pos = torch.cat([gtok, src], 1), torch.cat([gpos, pos], 1)
        full = torch.cat([torch.zeros(B, 1, dtype=torch.bool, device=src.device), valid.bool()], 1)
        for layer in self.encoder.layers:
            src = layer(src, full, pos)
        mem_global, mem = src[:, 0], src[:, 1:]
        nq = query_embed.shape[0]
        tgt = torch.zeros(B, nq, d, dtype=src.dtype, device=src.device)
        hs, refs = self.decoder(tgt, mem, valid, pos[:, 1:], query_embed[None].expand(B, nq, 2))
        return hs, refs, mem, mem_global


# -- MESM ---------------------------------------------------------------------


class SegSenRecon(nn.Module):
    def __init__(self, c: ModelConfig):
        super().__init__()
        d = c.hidden_dim
        self.masked_sent_token = nn.Parameter(torch.zeros(d))
        self.recon_trans = T2VStack(d, c.nheads, c.num_recss_layers, c.dim_feedforward)
        self.output_sent_proj = nn.ModuleList([LinearBlock(d, d, True), LinearBlock(d, d, False)])

    def forward(self, vid, vid_valid, sent, sent_valid, own_pos):
        B, G, _ = sent.shape
        own = F.one_hot(own_pos.long(), G).to(sent.dtype)[..., None]
        masked = sent * (1.0 - own) + self.masked_sent_token * own
        recon = self.recon_trans(vid, masked, vid_valid, None, None, sent_valid)
        recon_feat = l2n(recon[torch.arange(B, device=recon.device), own_pos.long()])
        x = recon_feat
        for blk in self.output_sent_proj:
            x = blk(x)
        return recon_feat, x


def mlm_choice(words_mask, words_weight, u):
    """max(l // 3, 1) word positions per row chosen without replacement with
    probability by weight: the top of log(w) + Gumbel(u)."""
    lengths = words_mask.sum(1)
    m = torch.clamp(lengths // 3, min=1)
    w = words_weight.float() * words_mask
    ok = w > 0
    g = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    s = torch.where(ok, torch.log(w.clamp(min=1e-30)) + g, torch.full_like(w, -float("inf")))
    ranks = torch.argsort(torch.argsort(-s, dim=1, stable=True), dim=1)
    return (ranks < m[:, None]) & ok & (lengths[:, None] > 1)


class MESM(nn.Module):
    def __init__(self, c: ModelConfig):
        super().__init__()
        self.c = c
        d = c.hidden_dim
        self.input_vid_proj = InputProj(c.v_feat_dim, d, c.n_input_proj)
        self.input_txt_proj = InputProj(c.t_feat_dim, d, c.n_input_proj)
        if c.rec_fw:
            self.enhance_encoder = T2VEncoder(d, c.nheads, c.num_recfw_layers, c.dim_feedforward,
                                              two_mlp=not c.share_mlp)
        self.t2v_encoder = T2VEncoder(d, c.nheads, c.t2v_layers, c.dim_feedforward)
        self.transformer = Transformer(d, c.nheads, c.enc_layers, c.dec_layers, c.dim_feedforward)
        self.span_embed = MLP(d, d, 2, 3)
        self.class_embed = nn.Linear(d, 2)
        self.query_embed = nn.Embedding(c.num_queries, 2)
        self.saliency_proj1, self.saliency_proj2 = nn.Linear(d, d), nn.Linear(d, d)
        self.global_rep_token = nn.Parameter(torch.zeros(d))
        self.global_rep_pos = nn.Parameter(torch.zeros(d))
        if c.rec_fw:
            self.masked_token = nn.Parameter(torch.zeros(c.t_feat_dim))
            self.unknown_token = nn.Parameter(torch.zeros(c.t_feat_dim))
            self.output_txt_proj = nn.Sequential(LinearBlock(d, d, True),
                                                 nn.Linear(d, c.num_classes))
        if c.rec_ss:
            self.ss_reconstructor = SegSenRecon(c)

    def forward(self, b: Dict[str, torch.Tensor], neg_rows=None, mlm_u=None):
        """b: one batch as the collate lays it out, on the device: the
        row's video (`video_feat`, or `video_feat_g` and `video_slot`),
        `video_mask`, the cached text (`cached_words_feat`,
        `cached_words_mask`, `cached_sentence_feat`), the SS-MESM group
        (`ss_sent_idx`, `ss_sent_mask`, `ss_own_pos`); in training
        `clip_mask`, `words_weight`, `unknown_mask`. neg_rows (B,): the
        negative pass's rows (training); mlm_u (B, Lw): the uniforms of the
        MLM draw (training)."""
        c = self.c
        d, H = c.hidden_dim, c.nheads
        vmask = b["video_mask"].bool()
        B, L = vmask.shape
        if "video_feat" in b:
            vfeat = b["video_feat"]
        else:
            vfeat = b["video_feat_g"][b["video_slot"].long()]
        words, wmask, sent = (b["cached_words_feat"], b["cached_words_mask"].bool(),
                              b["cached_sentence_feat"])
        vid = self.input_vid_proj(vfeat)
        vpos = sine_positions(vmask, d)
        pw = self.input_txt_proj(words)
        if c.rec_ss:
            ss_vid = self.input_vid_proj(vfeat) if self.training else vid
            group = self.input_txt_proj(sent[b["ss_sent_idx"].long()])
            recon_feat, projed_recon = self.ss_reconstructor(
                ss_vid, vmask, group, b["ss_sent_mask"].bool(), b["ss_own_pos"])
            xw = torch.cat([recon_feat[:, None], pw], 1)
            xm = torch.cat([torch.ones(B, 1, dtype=torch.bool, device=vmask.device), wmask], 1)
        else:
            xw, xm = pw, wmask
        out = {}
        if neg_rows is not None:
            neg = neg_rows.long()
            nxw, nxm = xw[neg], xm[neg]
            nw, nm = (nxw[:, 1:], nxm[:, 1:]) if c.rec_ss else (nxw, nxm)

            def halves(kp, kn):
                a, bb = pair_factors(vmask, kp, H), pair_factors(vmask, kn, H)
                return torch.cat([a[0], bb[0]]), torch.cat([a[1], bb[1]])

            vid2, vpos2, vmask2 = (torch.cat([t, t]) for t in (vid, vpos, vmask))
            if c.rec_fw:
                enh2 = self.enhance_encoder(torch.cat([pw, nw]), vid2, torch.cat([wmask, nm]),
                                            None, vpos2, pair=halves(wmask, nm))
            else:
                enh2 = vid2
            enc = self.t2v_encoder(torch.cat([xw, nxw]), enh2, torch.cat([xm, nxm]), None, vpos2,
                                   pair=halves(xm, nxm))
            rows, tmask, tpos2 = 2 * B, vmask2, vpos2
        else:
            enhanced = self.enhance_encoder(pw, vid, wmask, None, vpos, vmask) if c.rec_fw else vid
            enc = self.t2v_encoder(xw, enhanced, xm, None, vpos, vmask)
            rows, tmask, tpos2 = B, vmask, vpos
        gtok = self.global_rep_token.expand(rows, 1, d)
        gpos = self.global_rep_pos.expand(rows, 1, d)
        hs_all, ref_all, mem_all, memg_all = self.transformer(enc, tmask, self.query_embed.weight,
                                                              tpos2, gtok, gpos)
        hs, ref = hs_all[:, :B], ref_all[:, :B]
        cls = self.class_embed(hs)
        coord = torch.sigmoid(self.span_embed(hs) + inverse_sigmoid(ref))
        scale = float(1.0 / torch.sqrt(torch.tensor(float(d))))

        def saliency(mem, memg):
            return (self.saliency_proj1(mem) * self.saliency_proj2(memg)[:, None]).sum(-1) * scale

        out.update(pred_logits=cls[-1], pred_spans=coord[-1],
                   saliency_scores=saliency(mem_all[:B], memg_all[:B]))
        if c.aux_loss:
            out.update(aux_pred_logits=cls[:-1], aux_pred_spans=coord[:-1])
        if neg_rows is None:
            return out
        out["neg_saliency_scores"] = saliency(mem_all[B:], memg_all[B:])
        if c.rec_ss:
            out.update(projed_video_feat=vid, expanded_words_feat=xw, expanded_words_mask=xm)
        if c.rec_fw:
            unk = self.input_txt_proj(self.unknown_token[None, None])
            unknowned = torch.where(b["unknown_mask"].bool()[..., None], unk, pw)
            cmask = b["clip_mask"].bool()
            order = torch.argsort((~cmask).to(torch.int32), dim=1, stable=True)
            clips = torch.take_along_dim(vid, order[..., None], dim=1)
            clip_pos = torch.take_along_dim(vpos, order[..., None], dim=1)
            clip_valid = torch.arange(L, device=vmask.device)[None] < cmask.sum(1)[:, None]
            mtok = self.input_txt_proj(self.masked_token[None, None])
            masked = mlm_choice(wmask, b["words_weight"], mlm_u)
            mw = torch.where(masked[..., None], mtok, unknowned)
            rec = self.enhance_encoder(clips, mw, clip_valid, clip_pos, None, wmask, is_mlm=True)
            out.update(recfw_words_logit=self.output_txt_proj(rec), words_mask=wmask)
        return out
