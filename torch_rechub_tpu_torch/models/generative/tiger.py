"""TIGER: generative retrieval over semantic ids (arXiv:2305.05065).

Counterpart of ``torch_rechub_tpu/models/generative/tiger.py``: a compact
T5-style encoder-decoder (pre-norm layers, LayerNorm without bias at eps
1e-6 and flax's fast variance, no bias in any projection), a shared token
embedding, and the tied output head with T5's ``d_model**-0.5`` rescale;
the temperature ranking loss over labels other than ``-100``; and
``generate``, greedy or beam decoding with an optional prefix ``Trie``
(``utils/tiger.py``) over the valid semantic-id sequences.

Masked scores are set to ``-1e9`` (not ``-inf``, not ``finfo.min``), so
TIGER has its own attention.  Dropout is active in ``train()`` mode and
draws from the ``generator`` given to ``forward``.

The JAX package trains TIGER with a plain loop over ``optax.adamw(1e-3)``
(``examples/generative/run_rqvae_tiger.py``), whose decoupled weight decay
is 1e-4 on every parameter: ``torch.optim.AdamW(model.parameters(),
lr=1e-3, weight_decay=1e-4)`` is the same update.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ...basic.attention import LayerNorm
from ...basic.hstu import dropout
from ...basic.initializers import linear, normal, param
from ...basic.precision import softmax, weak
from ...trainers.base import resolve_device


def _layer_norm(d: int, device=None) -> LayerNorm:
    return LayerNorm(d, eps=1e-6, use_bias=False, device=device)


class _MHA(nn.Module):
    """Attention from ``q_in (B, Lq, d)`` to ``kv_in (B, Lk, d)`` under a boolean ``mask`` (True attends) broadcast
    to ``(B, H, Lq, Lk)``; masked scores are ``-1e9``, dropout falls on the full-shape probabilities."""

    def __init__(self, d_model: int, n_heads: int, dropout: float, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.n_heads, self.dropout = n_heads, dropout
        for name in ("q", "k", "v", "o"):
            self.add_module(name, linear(d_model, d_model, generator, device, bias=False))

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor, mask: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, lq, d = q_in.shape
        h = self.n_heads
        hd = d // h
        q = self.q(q_in).reshape(b, lq, h, hd)
        k, v = (m(kv_in).reshape(b, kv_in.shape[1], h, hd) for m in (self.k, self.v))
        scores = torch.einsum("blhd,bmhd->bhlm", q, k)
        scores = scores / weak(scores, math.sqrt(hd))
        if mask is not None:
            scores = torch.where(mask, scores, -1e9)
        attn = dropout(softmax(scores, dim=-1), self.dropout, self.training, generator)
        return self.o(torch.einsum("bhlm,bmhd->blhd", attn, v).reshape(b, lq, d))


class _FFN(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dropout: float, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.dropout = dropout
        self.Dense_0 = linear(d_model, d_ff, generator, device, bias=False)
        self.Dense_1 = linear(d_ff, d_model, generator, device, bias=False)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.Dense_1(dropout(torch.relu(self.Dense_0(x)), self.dropout, self.training, generator))


class _EncoderLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_ff: int, dropout: float, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.dropout = dropout
        self.LayerNorm_0 = _layer_norm(d_model, device)
        self._MHA_0 = _MHA(d_model, n_heads, dropout, generator, device)
        self.LayerNorm_1 = _layer_norm(d_model, device)
        self._FFN_0 = _FFN(d_model, d_ff, dropout, generator, device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        p, training = self.dropout, self.training
        h = self.LayerNorm_0(x)
        x = x + dropout(self._MHA_0(h, h, mask, generator), p, training, generator)
        return x + dropout(self._FFN_0(self.LayerNorm_1(x), generator), p, training, generator)


class _DecoderLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_ff: int, dropout: float, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.dropout = dropout
        self.LayerNorm_0 = _layer_norm(d_model, device)
        self.self_attn = _MHA(d_model, n_heads, dropout, generator, device)
        self.LayerNorm_1 = _layer_norm(d_model, device)
        self.cross_attn = _MHA(d_model, n_heads, dropout, generator, device)
        self.LayerNorm_2 = _layer_norm(d_model, device)
        self._FFN_0 = _FFN(d_model, d_ff, dropout, generator, device)

    def forward(self, x: torch.Tensor, enc: torch.Tensor, self_mask: torch.Tensor, cross_mask: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        p, training = self.dropout, self.training
        h = self.LayerNorm_0(x)
        x = x + dropout(self.self_attn(h, h, self_mask, generator), p, training, generator)
        h = self.LayerNorm_1(x)
        x = x + dropout(self.cross_attn(h, enc, cross_mask, generator), p, training, generator)
        return x + dropout(self._FFN_0(self.LayerNorm_2(x), generator), p, training, generator)


class TIGERModel(nn.Module):
    """Compact T5-style seq2seq over semantic-id tokens.

    ``forward(input_ids, attention_mask=None, labels=None, decoder_input_ids=None, generator=None)`` returns
    ``(loss, logits)``: labels are shifted right (the decoder starts at ``pad_token_id``) to form the decoder
    inputs; the loss is the temperature ranking loss, ``None`` without labels.
    """

    def __init__(self, vocab_size: int, d_model: int = 128, n_heads: int = 4, n_enc_layers: int = 2, n_dec_layers: int = 2, d_ff: int = 512, dropout: float = 0.1, max_len: int = 128, pad_token_id: int = 0, temperature: float = 1.0, generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.vocab_size, self.d_model, self.max_len = vocab_size, d_model, max_len
        self.pad_token_id, self.temperature = pad_token_id, temperature
        self.n_enc_layers, self.n_dec_layers = n_enc_layers, n_dec_layers
        init = normal(1.0 / d_model**0.5)
        self.shared_embedding = param(init, (vocab_size, d_model), generator, device)
        self.enc_pos = param(init, (max_len, d_model), generator, device)
        self.dec_pos = param(init, (max_len, d_model), generator, device)
        for i in range(n_enc_layers):
            self.add_module(f"enc_layers_{i}", _EncoderLayer(d_model, n_heads, d_ff, dropout, generator, device))
        for i in range(n_dec_layers):
            self.add_module(f"dec_layers_{i}", _DecoderLayer(d_model, n_heads, d_ff, dropout, generator, device))
        self.enc_final_ln = _layer_norm(d_model, device)
        self.dec_final_ln = _layer_norm(d_model, device)

    def encode(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None):
        """``(encoder states (B, L, d), attention mask (B, L))``; the mask defaults to ``input_ids != pad``."""
        input_ids = input_ids.to(torch.int64)
        if attention_mask is None:
            attention_mask = (input_ids != self.pad_token_id).to(torch.int32)
        x = F.embedding(input_ids, self.shared_embedding) + self.enc_pos[None, : input_ids.shape[1]]
        mask = attention_mask[:, None, None, :].to(torch.bool)
        for i in range(self.n_enc_layers):
            x = getattr(self, f"enc_layers_{i}")(x, mask, generator)
        return self.enc_final_ln(x), attention_mask

    def decode(self, decoder_input_ids: torch.Tensor, enc: torch.Tensor, enc_mask: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``(B, Ld, V)`` logits of the tied head: ``(x · d_model**-0.5) @ shared_embeddingᵀ``."""
        decoder_input_ids = decoder_input_ids.to(torch.int64)
        l = decoder_input_ids.shape[1]
        x = F.embedding(decoder_input_ids, self.shared_embedding) + self.dec_pos[None, :l]
        self_mask = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()[None, None]
        cross_mask = enc_mask[:, None, None, :].to(torch.bool)
        for i in range(self.n_dec_layers):
            x = getattr(self, f"dec_layers_{i}")(x, enc, self_mask, cross_mask, generator)
        x = self.dec_final_ln(x)
        return torch.einsum("bld,vd->blv", x * (self.d_model**-0.5), self.shared_embedding)

    def shift_right(self, labels: torch.Tensor) -> torch.Tensor:
        start = torch.full((labels.shape[0], 1), self.pad_token_id, dtype=labels.dtype, device=labels.device)
        shifted = torch.cat([start, labels[:, :-1]], dim=1)
        return torch.where(shifted == -100, self.pad_token_id, shifted)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None, labels: Optional[torch.Tensor] = None, decoder_input_ids: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None):
        enc, enc_mask = self.encode(input_ids, attention_mask, generator)
        if decoder_input_ids is None:
            if labels is None:
                raise ValueError("provide labels or decoder_input_ids")
            decoder_input_ids = self.shift_right(labels)
        logits = self.decode(decoder_input_ids, enc, enc_mask, generator)
        loss = None if labels is None else self.ranking_loss(logits, labels)
        return loss, logits

    def ranking_loss(self, lm_logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Temperature-scaled CE over the labels other than ``-100``, divided by ``max(count, 1)``."""
        mask = (labels != -100).to(torch.float32)
        safe = torch.where(labels == -100, 0, labels).to(torch.int64)
        logp = torch.log_softmax(lm_logits / self.temperature, dim=-1)
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


@torch.inference_mode()
def generate(model: TIGERModel, input_ids, max_new_tokens: int, num_beams: int = 1, trie=None, eos_token_id: Optional[int] = None, device=None):
    """Greedy / beam decoding (scores: sums of log-probabilities) with an optional prefix ``trie``
    (``utils.tiger.Trie``) allowing only the children of the generated prefix.  Returns, per row of ``input_ids``,
    up to ``num_beams`` token lists (the leading pad stripped), best first.

    Decodes on the card unless ``device`` names another (``trainers.base.resolve_device``: without a card and
    without ``device="cpu"`` it raises); the model must already lie there.

    A host loop over 3-5 steps, as the JAX package's: the input is encoded once; each step runs the full decoder over
    every live beam and reads its last column.  A row whose beams all ran out of allowed tokens keeps its best beam
    (``beams[i][:1]``), which is then shorter than the others: it is padded with 0 at the end and its last column (a
    0) is still read, as there.  The log-softmax is taken on the device, then copied to the host; candidates are
    ranked with ``sorted(allowed, key=-row[t])`` (stable, in the trie's insertion order) under a trie and
    ``np.argsort(-row)`` without one, the same host calls as the JAX package's, so ties order as they do there.
    """
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if model.shared_embedding.device != device:
        raise ValueError(f"the model lies on {model.shared_embedding.device} but generate runs on {device}: move it with model.to({str(device)!r})")
    was_training = model.training
    model.eval()
    try:
        return _beam_search(model, input_ids, max_new_tokens, num_beams, trie, eos_token_id)
    finally:
        model.train(was_training)


def _beam_search(model: TIGERModel, input_ids, max_new_tokens: int, num_beams: int, trie, eos_token_id: Optional[int]):
    device = model.shared_embedding.device
    input_ids = np.asarray(input_ids)
    b = input_ids.shape[0]
    enc, enc_mask = model.encode(torch.as_tensor(input_ids, device=device))

    beams = [[(0.0, [model.pad_token_id])] for _ in range(b)]
    finished = [[] for _ in range(b)]
    for _t in range(max_new_tokens):
        all_dec, all_scores, meta = [], [], []
        for i in range(b):
            for score, toks in beams[i]:
                all_dec.append(toks)
                all_scores.append(score)
                meta.append(i)
        maxlen = max(len(t) for t in all_dec)
        dec = np.zeros((len(all_dec), maxlen), dtype=np.int32)
        for r, toks in enumerate(all_dec):
            dec[r, : len(toks)] = toks
        rows = torch.as_tensor(np.asarray(meta), device=device)
        step = model.decode(torch.as_tensor(dec, device=device), enc[rows], enc_mask[rows])[:, -1, :]
        logits = torch.log_softmax(step, dim=-1).cpu().numpy()
        new_beams = [[] for _ in range(b)]
        for r, i in enumerate(meta):
            score, toks = all_scores[r], all_dec[r]
            row = logits[r]
            if trie is not None:
                allowed = trie.allowed_next(tuple(toks[1:]))
                if not allowed:
                    continue
                cand = sorted(allowed, key=lambda t: -row[t])[:num_beams]
            else:
                cand = np.argsort(-row)[:num_beams].tolist()
            for t in cand:
                nb = (score + float(row[t]), toks + [int(t)])
                if eos_token_id is not None and t == eos_token_id:
                    finished[i].append(nb)
                else:
                    new_beams[i].append(nb)
        beams = [sorted(nb, key=lambda x: -x[0])[:num_beams] if nb else beams[i][:1] for i, nb in enumerate(new_beams)]
    out = []
    for i in range(b):
        pool = sorted(finished[i] + beams[i], key=lambda x: -x[0])
        out.append([toks[1:] for _score, toks in pool[:num_beams]])
    return out
