"""MESM top-level model, inference path.

Parity targets: mesm_tpu/models/mesm.py and the reference model/model.py
(MESM :16-394, SegSenRecon :437-503), for inference: no negative pass, no
MLM masking, deterministic. Unique videos are projected once
(`video_feat_g`, `video_slot`) and rows gathered after the wide input
projection (mesm.py:396-404); SS-MESM reuses that projection, which is
value-identical to the reference's second projection draw in eval
(mesm.py:421-426). The text encoders are frozen and live outside this
module: it consumes encoded text features.

Module and parameter names are the upstream torch state-dict names, and
every module the upstream model constructs for the config exists here, so
`load_state_dict(strict=True)` takes an upstream checkpoint. The modules
only training reads (output_txt_proj, masked_token, unknown_token, the TwoMLP
halves) are loaded but not run.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from ..ops.masking import l2_normalize
from .detr import Transformer, inverse_sigmoid
from .layers import MLP, InputProj, LinearBlock, Linear
from .position import TrainablePositionEmbedding, sine_position_embedding
from .t2v import T2VEncoder, T2VStack


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
    ) -> Dict[str, torch.Tensor]:
        c = self.cfg
        B = video_mask.shape[0]
        dt = words_feat.dtype
        if video_feat_g is not None:
            slot = video_slot.long()
            projed_video_feat = self.input_vid_proj(video_feat_g)[slot]
            vid_position = sine_position_embedding(video_mask_g, c.hidden_dim, dtype=dt)[slot]
        else:
            projed_video_feat = self.input_vid_proj(video_feat)
            vid_position = sine_position_embedding(video_mask, c.hidden_dim, dtype=dt)
        projed_words_feat = self.input_txt_proj(words_feat)
        txt_position = self._txt_pos(projed_words_feat)

        if c.rec_ss:
            # single-video groups (charades family): the SS-recon video is the
            # (deterministic, deduplicated) main projection
            group_sent = sentence_feat[ss_sent_idx.long()]  # (B, G, Dt)
            batched_sent = self.input_txt_proj(group_sent).to(dt)
            recon_feat, _ = self.ss_reconstructor(
                projed_video_feat, video_mask, batched_sent, ss_sent_mask, ss_own_pos
            )
            expanded_words_feat = torch.cat([recon_feat[:, None].to(dt), projed_words_feat], dim=1)
            expanded_words_mask = torch.cat(
                [torch.ones(B, 1, dtype=torch.bool, device=words_mask.device), words_mask.bool()],
                dim=1,
            )
        else:
            expanded_words_feat = projed_words_feat
            expanded_words_mask = words_mask.bool()
        expanded_txt_position = self._txt_pos(expanded_words_feat)

        if c.rec_fw:
            enhanced_video_feat = self.enhance_encoder(
                projed_words_feat, projed_video_feat, words_mask, txt_position, vid_position,
                video_mask,
            )
        else:
            enhanced_video_feat = projed_video_feat
        encoded_video_feat = self.t2v_encoder(
            expanded_words_feat, enhanced_video_feat, expanded_words_mask, expanded_txt_position,
            vid_position, video_mask,
        )

        edt = encoded_video_feat.dtype
        global_token = self.global_rep_token.to(edt).expand(B, 1, c.hidden_dim)
        global_token_pos = self.global_rep_pos.to(edt).expand(B, 1, c.hidden_dim)
        hs, reference, memory, memory_global = self.transformer(
            encoded_video_feat, video_mask, self.query_embed.weight, vid_position,
            global_token, global_token_pos,
        )
        outputs_class = self.class_embed(hs)  # (#layers, B, nq, 2)
        outputs_coord = torch.sigmoid(self.span_embed(hs) + inverse_sigmoid(reference))
        scale = 1.0 / torch.sqrt(torch.tensor(float(c.hidden_dim)))
        saliency_scores = (
            self.saliency_proj1(memory) * self.saliency_proj2(memory_global)[:, None]
        ).sum(-1) * scale.to(memory.device)
        out: Dict[str, torch.Tensor] = {
            "pred_logits": outputs_class[-1],
            "pred_spans": outputs_coord[-1],
            "saliency_scores": saliency_scores,
        }
        if c.aux_loss:
            out["aux_pred_logits"] = outputs_class[:-1]
            out["aux_pred_spans"] = outputs_coord[:-1]
        return out
