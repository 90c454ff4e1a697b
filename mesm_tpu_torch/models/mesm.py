"""MESM top-level model: inference and the training forward.

Parity targets: mesm_tpu/models/mesm.py and the reference model/model.py
(MESM :16-394, SegSenRecon :437-503). The text encoders are frozen and live
outside this module: it consumes encoded text features.

Inference (eval mode, no `neg_idx_rows`): no negative pass, no MLM masking.
Unique videos may be projected once (`video_feat_g`, `video_slot`) and rows
gathered after the wide input projection (mesm.py:396-404); SS-MESM reuses
that projection, which is value-identical to the reference's second
projection draw in eval (mesm.py:421-426).

Multi-clip (QVHighlights) rows carry their group's concatenated clips as
`ss_video_feat` / `ss_video_mask` (data/pipeline.stage_batch expands them
per row): SS-MESM then reconstructs the sentence from that video, projected
on its own (mesm.py:431-436), in eval and in training.

Training (train mode, with `neg_idx_rows`, mesm.py:340-651): each row's
video is projected with its own dropout draw, SS-MESM takes a second,
independent draw (:416-430), the positive and negative (out-of-group text)
passes run stacked as 2B rows with the scrambled pair factors computed per
half (:469-528), `neg_saliency_scores` feeds the saliency loss, the rec_ss
outputs are returned (:606-615), and the MLM branch (:617-651) masks words
with a weighted Gumbel top-k draw from an explicit torch.Generator, or takes
the mask it is given (`masked_words_loc`, which the parity tests fill from
the JAX package's output, since the two frameworks draw different numbers).

Module and parameter names are the upstream torch state-dict names, and
every module the upstream model constructs for the config exists here, so
`load_state_dict(strict=True)` takes an upstream checkpoint.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from ..ops.masking import l2_normalize, lengths_to_mask
from .detr import Transformer, inverse_sigmoid
from .layers import MLP, InputProj, LinearBlock, Linear
from .position import TrainablePositionEmbedding, sine_position_embedding
from .t2v import T2VEncoder, T2VStack, scrambled_pair_factors


@dataclass(frozen=True)
class MESMConfig:
    # dims
    hidden_dim: int = 256
    v_feat_dim: int = 2818  # includes +2 TEF when use_tef
    t_feat_dim: int = 512
    nheads: int = 8
    dim_feedforward: int = 1024
    # depths
    num_recfw_layers: int = 2
    t2v_layers: int = 2
    enc_layers: int = 2
    dec_layers: int = 2
    num_recss_layers: int = 4
    # behavior
    num_queries: int = 10
    dropout: float = 0.1
    input_dropout: float = 0.5
    n_input_proj: int = 2
    use_txt_pos: bool = False
    max_words_l: int = 32
    max_video_l: int = 75
    rec_fw: bool = True
    rec_ss: bool = True
    share_mlp: bool = True  # False -> TwoMLP enhance encoder
    aux_loss: bool = True
    num_classes: int = 1114  # MLM head classes
    activation: str = "prelu"


class SegSenRecon(nn.Module):
    """SS-MESM: mask each sample's own sentence within its video group and
    reconstruct it from the group's video through a T2V stack (video as k/v).
    The inner stack keeps torch Linear default init."""

    def __init__(self, c: MESMConfig):
        super().__init__()
        d = c.hidden_dim
        self.masked_sent_token = nn.Parameter(torch.zeros(d))
        self.recon_trans = T2VStack(
            d, c.nheads, c.num_recss_layers, c.dim_feedforward, c.dropout, c.activation,
            two_mlp=False, xavier_init=False,
        )
        self.output_sent_proj = nn.ModuleList([
            LinearBlock(d, d, dropout=c.input_dropout, relu=True),
            LinearBlock(d, d, dropout=c.input_dropout, relu=False),
        ])

    def forward(self, batched_vid, batched_vid_mask, batched_sent, batched_sent_mask, own_pos):
        B, G, d = batched_sent.shape
        own = torch.nn.functional.one_hot(own_pos.long(), G).to(batched_sent.dtype)[..., None]
        masked_sent = batched_sent * (1.0 - own) + self.masked_sent_token.to(batched_sent.dtype) * own
        # video is keys/values, the masked sentence set the query stream;
        # positions unused (reference model.py:478-482)
        recon = self.recon_trans(batched_vid, masked_sent, batched_vid_mask, None, None,
                                 batched_sent_mask)
        recon_own = recon[torch.arange(B, device=recon.device), own_pos.long()]
        recon_feat = l2_normalize(recon_own)
        x = recon_feat
        for blk in self.output_sent_proj:
            x = blk(x)
        return recon_feat, x


def gumbel_mask_words_choice(words_mask: torch.Tensor, words_weight: torch.Tensor,
                             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Choose max(l // 3, 1) word positions per row, weighted, without
    replacement, as a (B, L) bool mask (mesm_tpu/models/mesm.py:146-170).
    The top-m of log(w) + Gumbel noise has the law of m successive weighted
    draws without replacement (the reference's np.random.choice,
    model/model.py:361-384). Rows with at most one word are left unmasked.
    The noise comes from `generator` (the default generator when None)."""
    lengths = words_mask.sum(1)
    num_masked = torch.clamp(lengths // 3, min=1)
    w = words_weight.float() * words_mask
    eligible = w > 0
    u = torch.rand(w.shape, generator=generator, device=w.device)
    g = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    scores = torch.where(eligible, torch.log(w.clamp(min=1e-30)) + g,
                         torch.full_like(w, -float("inf")))
    order = torch.argsort(-scores, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1)
    return (ranks < num_masked[:, None]) & eligible & (lengths[:, None] > 1)


class MESM(nn.Module):
    def __init__(self, cfg: MESMConfig):
        super().__init__()
        c = self.cfg = cfg
        d = c.hidden_dim
        self.input_vid_proj = InputProj(c.v_feat_dim, d, c.n_input_proj, c.input_dropout)
        self.input_txt_proj = InputProj(c.t_feat_dim, d, c.n_input_proj, c.input_dropout)
        if c.use_txt_pos:
            self.txt_position_embed = TrainablePositionEmbedding(
                c.max_words_l + 1 if c.rec_ss else c.max_words_l, d, c.input_dropout
            )
        if c.rec_fw:
            self.enhance_encoder = T2VEncoder(
                d, c.nheads, c.num_recfw_layers, c.dim_feedforward, c.dropout, c.activation,
                two_mlp=not c.share_mlp,
            )
        self.t2v_encoder = T2VEncoder(
            d, c.nheads, c.t2v_layers, c.dim_feedforward, c.dropout, c.activation
        )
        self.transformer = Transformer(
            d, c.nheads, c.enc_layers, c.dec_layers, c.dim_feedforward, c.dropout, c.activation
        )
        self.span_embed = MLP(d, d, 2, 3)
        self.class_embed = Linear(d, 2)
        self.query_embed = nn.Embedding(c.num_queries, 2)
        self.saliency_proj1 = Linear(d, d)
        self.saliency_proj2 = Linear(d, d)
        self.global_rep_token = nn.Parameter(torch.randn(d))
        self.global_rep_pos = nn.Parameter(torch.randn(d))
        if c.rec_fw:
            self.masked_token = nn.Parameter(torch.zeros(c.t_feat_dim))
            self.unknown_token = nn.Parameter(torch.zeros(c.t_feat_dim))
            self.output_txt_proj = nn.Sequential(
                LinearBlock(d, d, dropout=c.input_dropout, relu=True),
                Linear(d, c.num_classes),
            )
        if c.rec_ss:
            self.ss_reconstructor = SegSenRecon(c)

    def _txt_pos(self, feat):
        if self.cfg.use_txt_pos:
            return self.txt_position_embed(feat)
        return torch.zeros_like(feat)

    def forward(
        self,
        video_mask: torch.Tensor,  # (B, Lv) bool
        words_feat: torch.Tensor,  # (B, Lw, Dt) encoded text
        words_mask: torch.Tensor,  # (B, Lw) bool
        sentence_feat: torch.Tensor,  # (B, Dt)
        video_feat: Optional[torch.Tensor] = None,  # (B, Lv, Dv); None with video_feat_g
        video_feat_g: Optional[torch.Tensor] = None,  # (NG, Lv, Dv) unique videos
        video_mask_g: Optional[torch.Tensor] = None,  # (NG, Lv)
        video_slot: Optional[torch.Tensor] = None,  # (B,) row -> unique video
        ss_sent_idx: Optional[torch.Tensor] = None,  # (B, G) row indices of the group
        ss_sent_mask: Optional[torch.Tensor] = None,  # (B, G)
        ss_own_pos: Optional[torch.Tensor] = None,  # (B,)
        ss_video_feat: Optional[torch.Tensor] = None,  # (B, Lss, Dv) qvh group video
        ss_video_mask: Optional[torch.Tensor] = None,  # (B, Lss)
        neg_idx_rows: Optional[torch.Tensor] = None,  # (B,) out-of-group rows: the negative pass
        clip_mask: Optional[torch.Tensor] = None,  # (B, Lv) GT-span clips (MLM)
        words_weight: Optional[torch.Tensor] = None,  # (B, Lw) (MLM)
        unknown_mask: Optional[torch.Tensor] = None,  # (B, Lw) (MLM)
        masked_words_loc: Optional[torch.Tensor] = None,  # (B, Lw) injected MLM mask
        mask_generator: Optional[torch.Generator] = None,  # the MLM draw's generator
    ) -> Dict[str, torch.Tensor]:
        c = self.cfg
        B = video_mask.shape[0]
        dt = words_feat.dtype
        words_mask = words_mask.bool()

        def project_video():
            if video_feat_g is not None:
                return self.input_vid_proj(video_feat_g)[video_slot.long()]
            return self.input_vid_proj(video_feat)

        projed_video_feat = project_video()
        if video_feat_g is not None:
            vid_position = sine_position_embedding(video_mask_g, c.hidden_dim, dtype=dt)[video_slot.long()]
        else:
            vid_position = sine_position_embedding(video_mask, c.hidden_dim, dtype=dt)
        projed_words_feat = self.input_txt_proj(words_feat)
        txt_position = self._txt_pos(projed_words_feat)

        if c.rec_ss:
            if ss_video_feat is None:
                # single-video groups (charades family): in eval the SS-recon
                # video is the main projection; in training a second,
                # independent draw
                batched_vid = project_video() if self.training else projed_video_feat
                batched_vid_mask = video_mask
            else:  # qvhighlights: the group's concatenated clips
                batched_vid = self.input_vid_proj(ss_video_feat)
                batched_vid_mask = ss_video_mask
            group_sent = sentence_feat[ss_sent_idx.long()]  # (B, G, Dt)
            batched_sent = self.input_txt_proj(group_sent).to(dt)
            recon_feat, projed_recon_feat = self.ss_reconstructor(
                batched_vid, batched_vid_mask, batched_sent, ss_sent_mask, ss_own_pos
            )
            expanded_words_feat = torch.cat([recon_feat[:, None].to(dt), projed_words_feat], dim=1)
            expanded_words_mask = torch.cat(
                [torch.ones(B, 1, dtype=torch.bool, device=words_mask.device), words_mask], dim=1
            )
        else:
            expanded_words_feat = projed_words_feat
            expanded_words_mask = words_mask
        expanded_txt_position = self._txt_pos(expanded_words_feat)

        if neg_idx_rows is not None:
            # the negative pass (mismatched text of other groups) stacked
            # with the positive one as 2B rows; row-wise the same values as
            # two calls, except the scrambled pair mask, whose factors are
            # taken per half (it depends on each call's row count)
            neg = neg_idx_rows.long()
            neg_expanded_words_feat = expanded_words_feat[neg]
            neg_expanded_words_mask = expanded_words_mask[neg]
            neg_expanded_txt_position = expanded_txt_position[neg]
            if c.rec_ss:  # the recon token is dropped for the enhance input
                neg_words_feat = neg_expanded_words_feat[:, 1:]
                neg_words_mask = neg_expanded_words_mask[:, 1:]
                neg_txt_position = neg_expanded_txt_position[:, 1:]
            else:
                neg_words_feat = neg_expanded_words_feat
                neg_words_mask = neg_expanded_words_mask
                neg_txt_position = neg_expanded_txt_position

            def stack(a, b):
                return torch.cat([a, b], dim=0)

            def half_factors(kmask_pos, kmask_neg):
                fa = scrambled_pair_factors(video_mask, kmask_pos, c.nheads)
                fb = scrambled_pair_factors(video_mask, kmask_neg, c.nheads)
                return stack(fa[0], fb[0]), stack(fa[1], fb[1])

            video2 = stack(projed_video_feat, projed_video_feat)
            vid_position2 = stack(vid_position, vid_position)
            if c.rec_fw:
                enhanced2 = self.enhance_encoder(
                    stack(projed_words_feat, neg_words_feat), video2,
                    stack(words_mask, neg_words_mask), stack(txt_position, neg_txt_position),
                    vid_position2, pair_factors=half_factors(words_mask, neg_words_mask),
                )
            else:
                enhanced2 = video2
            enhanced_video_feat = enhanced2[:B]
            encoded_video_feat = self.t2v_encoder(
                stack(expanded_words_feat, neg_expanded_words_feat), enhanced2,
                stack(expanded_words_mask, neg_expanded_words_mask),
                stack(expanded_txt_position, neg_expanded_txt_position), vid_position2,
                pair_factors=half_factors(expanded_words_mask, neg_expanded_words_mask),
            )
            n_rows, t_mask, t_pos = 2 * B, stack(video_mask, video_mask), vid_position2
        else:
            if c.rec_fw:
                enhanced_video_feat = self.enhance_encoder(
                    projed_words_feat, projed_video_feat, words_mask, txt_position, vid_position,
                    video_mask,
                )
            else:
                enhanced_video_feat = projed_video_feat
            encoded_video_feat = self.t2v_encoder(
                expanded_words_feat, enhanced_video_feat, expanded_words_mask,
                expanded_txt_position, vid_position, video_mask,
            )
            n_rows, t_mask, t_pos = B, video_mask, vid_position

        edt = encoded_video_feat.dtype
        global_token = self.global_rep_token.to(edt).expand(n_rows, 1, c.hidden_dim)
        global_token_pos = self.global_rep_pos.to(edt).expand(n_rows, 1, c.hidden_dim)
        hs_all, reference_all, memory_all, memory_global_all = self.transformer(
            encoded_video_feat, t_mask, self.query_embed.weight, t_pos,
            global_token, global_token_pos,
        )
        hs, reference = hs_all[:, :B], reference_all[:, :B]
        memory, memory_global = memory_all[:B], memory_global_all[:B]
        outputs_class = self.class_embed(hs)  # (#layers, B, nq, 2)
        outputs_coord = torch.sigmoid(self.span_embed(hs) + inverse_sigmoid(reference))
        scale = (1.0 / torch.sqrt(torch.tensor(float(c.hidden_dim)))).to(memory.device)

        def saliency(mem, mem_global):
            return (self.saliency_proj1(mem) * self.saliency_proj2(mem_global)[:, None]).sum(-1) * scale

        out: Dict[str, torch.Tensor] = {
            "pred_logits": outputs_class[-1],
            "pred_spans": outputs_coord[-1],
            "saliency_scores": saliency(memory, memory_global),
        }
        if c.aux_loss:
            out["aux_pred_logits"] = outputs_class[:-1]
            out["aux_pred_spans"] = outputs_coord[:-1]
        if neg_idx_rows is None:
            return out

        out["neg_saliency_scores"] = saliency(memory_all[B:], memory_global_all[B:])
        if c.rec_ss:
            out.update(
                projed_video_feat=projed_video_feat,
                recon_feat=recon_feat,
                projed_recon_feat=projed_recon_feat,
                expanded_words_feat=expanded_words_feat,
                expanded_words_mask=expanded_words_mask,
                enhanced_video_feat=enhanced_video_feat,
                projed_words_feat=projed_words_feat,
            )

        if c.rec_fw and self.training:
            # MLM: masked words are reconstructed from the row's GT clips
            unk = self.input_txt_proj(self.unknown_token[None, None].to(dt))
            unknowned_words_feat = torch.where(unknown_mask.bool()[..., None], unk, projed_words_feat)
            # compact each row's GT clips to the front, in order
            Lv = video_mask.shape[1]
            order = torch.argsort((~clip_mask.bool()).to(torch.int32), dim=1, stable=True)
            merged_clip_feat = torch.take_along_dim(projed_video_feat, order[..., None], dim=1)
            merged_clip_position = torch.take_along_dim(vid_position, order[..., None], dim=1)
            merged_clip_mask = lengths_to_mask(clip_mask.bool().sum(1), Lv)
            masked_token = self.input_txt_proj(self.masked_token[None, None].to(dt))
            if masked_words_loc is None:
                masked_words_loc = gumbel_mask_words_choice(words_mask, words_weight, mask_generator)
            masked_words_loc = masked_words_loc.bool()
            masked_words_feat = torch.where(masked_words_loc[..., None], masked_token,
                                            unknowned_words_feat)
            recfw_out = self.enhance_encoder(
                merged_clip_feat, masked_words_feat, merged_clip_mask, merged_clip_position,
                txt_position, words_mask, is_mlm=True,
            )
            out["recfw_words_logit"] = self.output_txt_proj(recfw_out)
            out["words_mask"] = words_mask
            out["masked_words_loc"] = masked_words_loc
        return out
