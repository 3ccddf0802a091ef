"""Caption decoding and detokenization (``imagecaptioner_tpu/ops/decode.py``):
the students' greedy decode, and the teacher's KV-cached greedy decode and
beam searches.

``best_greedy_decode_student`` keeps its JAX name and picks the path by the
variant and by the tensor it is given.  For the full and the compact student:

* a CUDA tensor with ``rng=None``: the variant's greedy kernel
  (``ops/greedy.py``);
* a CPU tensor with ``rng=None``: the kernel's plain version;
* ``rng`` (a ``torch.Generator``) given: the plain version, sampling from
  softmax(logits / temperature), on either device.  The JAX package has no
  sampling kernel either.

There is no fallback: a kernel that cannot take its inputs raises.  The
enhanced student has no greedy kernel in the JAX package, and none here: it
decodes through ``greedy_decode_student``, the generic step loop over
``Student.decoder_step``, which takes any variant.

The teacher's loops are Python loops over ``decoder_step_cached``.  The beam
search is the fixed-width masked emulation of the reference's shrinking beam:
K slots per image, ``n_live`` of them accepted, finished hypotheses collected
in candidate order, survivors compacted in score order.  The KV cache is
never reordered; an ancestry table says which slot wrote each position of a
beam's lineage, and on a CUDA tensor the step's two attention cores are the
kernels of ``ops/beam_attn.py``.  The JAX package's switches between XLA
lowerings of the same search (physical cache permutation, the
selection-first ancestry form, the fusion barrier) have identical outputs
and are not carried over.  Under a profiler each beam step is a span
``beam.step`` holding ``beam.decoder`` and ``beam.select``, after its own
``beam.exit_check`` (``core/spans.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from imagecaptioner_tpu_torch.core.config import StudentConfig
from imagecaptioner_tpu_torch.core.spans import span
from imagecaptioner_tpu_torch.data.vocabulary import END, PAD, START
from imagecaptioner_tpu_torch.models import lstm as L
from imagecaptioner_tpu_torch.models import transformer as TD
from imagecaptioner_tpu_torch.models.student import check_variant
from imagecaptioner_tpu_torch.models.student_enhanced import MAX_POS
from imagecaptioner_tpu_torch.ops import greedy as G

BeamResult = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@torch.no_grad()
def greedy_decode_student(student, feats: torch.Tensor, cfg: StudentConfig, *,
                          max_length: int = 20, temperature: float = 1.0,
                          rng: Optional[torch.Generator] = None,
                          early_exit: bool = True) -> torch.Tensor:
    """The generic greedy (or, with ``rng``, sampled) decode: a Python loop
    over ``student.decoder_step``, for any variant.  The enhanced student
    adds its learned position ``t`` (< ``MAX_POS``) to each step's word
    embedding.  With ``early_exit`` the loop stops once every row has
    emitted END, which leaves the output unchanged."""
    B, dev = feats.shape[0], feats.device
    hc = L.init_hidden(cfg.num_layers, B, cfg.hidden_size, feats.dtype, dev)
    tok = torch.full((B,), START, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    out = torch.full((B, max_length), PAD, dtype=torch.int32, device=dev)
    for t in range(max_length):
        if early_exit and bool(done.all()):
            break
        emb = student.decoder.embedding(tok).to(feats.dtype)
        if cfg.variant == "enhanced" and t < MAX_POS:
            emb = emb + student.decoder.pos_encoding[0, t].to(emb.dtype)
        logits, hc, _ = student.decoder_step(emb, hc, feats)
        tok, done = G.next_token(logits, tok, done, out[:, t], temperature,
                                 rng)
    return out


def best_greedy_decode_student(student, feats: torch.Tensor,
                               cfg: StudentConfig, *, max_length: int = 20,
                               temperature: float = 1.0,
                               rng: Optional[torch.Generator] = None
                               ) -> torch.Tensor:
    """Greedy (or, with ``rng``, sampled) decode over refined features
    (B, L, E).  Returns (B, max_length) int32; PAD at and after the first
    END."""
    check_variant(cfg)
    kw = dict(max_length=max_length, temperature=temperature)
    if cfg.variant == "enhanced":
        return greedy_decode_student(student, feats, cfg, rng=rng, **kw)
    on_kernel = rng is None and feats.is_cuda
    if rng is None and not feats.is_cuda and feats.device.type != "cpu":
        raise ValueError(f"greedy decode: unsupported device {feats.device}")
    if cfg.variant == "compact":
        w = G.greedy_compact_operands(student.decoder, feats.dtype)
        if on_kernel:
            return G.greedy_decode_compact_cuda(w, feats.contiguous(), **kw)
        return G.greedy_decode_compact_plain(w, feats, generator=rng, **kw)
    w = G.greedy_operands(student.decoder, feats.dtype)
    f_proj = G.attention_feature_projection(w, feats)
    if on_kernel:
        return G.greedy_decode_cuda(w, feats, f_proj, **kw)
    return G.greedy_decode_plain(w, feats, f_proj, generator=rng, **kw)


# ---------------------------------------------------------------------------
# Teacher step machinery
# ---------------------------------------------------------------------------


def _teacher_logits_step(teacher, y: torch.Tensor) -> torch.Tensor:
    """(B, 1, E) decoder output -> (B, V) float32 logits (norm + head)."""
    return teacher.fc_out(teacher.pre_output_norm(y))[:, 0, :].float()


def _teacher_embed_step(teacher, tok: torch.Tensor, pos: int) -> torch.Tensor:
    """(B,) token + position -> (B, 1, E) with the sinusoidal table's row
    cast to the embedding's dtype."""
    emb = teacher.embedding(tok)[:, None, :]
    return emb + teacher.pe[pos:pos + 1][None].to(emb.dtype)


@torch.no_grad()
def greedy_decode_teacher(teacher, memory: torch.Tensor, *,
                          max_length: int = 20, temperature: float = 1.0,
                          sample: bool = False,
                          rng: Optional[torch.Generator] = None,
                          early_exit: bool = True) -> torch.Tensor:
    """Batched KV-cached greedy (or, with ``sample`` and ``rng``, sampled)
    decode.  memory (B, L, E) -> (B, max_length) int32 tokens, PAD at and
    after the first END.

    With ``early_exit`` the loop stops once every row has emitted END: the
    steps after that would only write PAD into a buffer that is already PAD,
    so the output is the full loop's."""
    cfg = teacher.cfg
    B, dev = memory.shape[0], memory.device
    layers = teacher.decoder
    mem_kv = TD.precompute_memory_kv(layers, memory, num_heads=cfg.num_heads)
    self_kv = TD.init_kv_cache(len(layers), B, max_length + 1, cfg.embed_size,
                               memory.dtype, num_heads=cfg.num_heads,
                               device=dev)
    tok = torch.full((B,), START, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    out = torch.full((B, max_length), PAD, dtype=torch.int32, device=dev)
    for t in range(max_length):
        if early_exit and bool(done.all()):
            break
        x = _teacher_embed_step(teacher, tok, t).to(memory.dtype)
        y, self_kv = TD.decoder_step_cached(layers, x, t, self_kv, mem_kv,
                                            num_heads=cfg.num_heads)
        logits = _teacher_logits_step(teacher, y)
        if temperature != 1.0:
            logits = logits / temperature
        if sample:
            nxt = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                    generator=rng)[:, 0]
        else:
            nxt = logits.argmax(dim=-1)
        done = done | (nxt == END)
        out[:, t] = torch.where(done, PAD, nxt).to(torch.int32)
        tok = torch.where(done, tok, nxt)   # finished rows keep their token
    return out


# ---------------------------------------------------------------------------
# Teacher beam search (fixed-width masked; reference shrink semantics)
# ---------------------------------------------------------------------------


def _length_penalty(length: int, length_penalty: float) -> float:
    """GNMT penalty ((5 + length) / 6) ** p in float32."""
    if length_penalty <= 0:
        return 1.0
    base = np.float32((5.0 + length) / 6.0)
    return float(base ** np.float32(length_penalty))


def _beam_bookkeeping(state: Dict[str, torch.Tensor], top_scores: torch.Tensor,
                      origin: torch.Tensor, token: torch.Tensor, t: int,
                      length_penalty: float
                      ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Accept / finalize / compact for N images at once; every tensor has a
    leading (N, K).  Only the first ``n_live`` score-ordered candidates are
    accepted (the reference's ``topk(B_live)`` with a shrinking beam), END
    candidates finalize with the GNMT penalty in candidate order, survivors
    compact into slots 0..n_new-1 in score order.  Returns the new state
    (without cache and ancestry) and, per new slot, the slot it came from."""
    seqs = state["seqs"]
    N, K, S = seqs.shape
    ar = torch.arange(K, device=seqs.device)
    accepted = ar[None] < state["n_live"][:, None]
    is_end = token == END
    finite = torch.isfinite(top_scores)
    finalize = accepted & is_end & finite
    keep = accepted & ~is_end & finite

    def rows_from(src: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
        """seqs[n, src[n, i]] with ``tok`` written at position t+1."""
        rows = seqs.gather(1, src[:, :, None].expand(N, K, S)).clone()
        rows[:, :, t + 1] = tok
        return rows

    # finalize into the finished buffer, candidate order preserved; a
    # candidate that does not finalize is written to a spare row K and dropped
    hyp_len = t + 2                     # includes START and END
    norm = top_scores / _length_penalty(hyp_len, length_penalty)
    slot = state["fin_count"][:, None] + finalize.long().cumsum(1) - 1
    slot = torch.where(finalize, slot, K)

    def scatter(buf: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
        spare = torch.cat([buf, buf[:, :1]], dim=1)
        idx = slot.reshape(N, K, *[1] * (buf.dim() - 2)).expand_as(vals)
        return spare.scatter(1, idx, vals)[:, :K]

    fin_seqs = scatter(state["fin_seqs"], rows_from(origin, token))
    fin_scores = scatter(state["fin_scores"], norm)
    fin_lens = scatter(state["fin_lens"], torch.full_like(token, hyp_len))
    fin_count = state["fin_count"] + finalize.sum(1)

    # survivors first, in candidate (score) order
    src = torch.argsort(torch.where(keep, ar, K + ar), dim=1, stable=True)
    n_new = keep.sum(1)
    origin_src = origin.gather(1, src)
    new_scores = torch.where(ar[None] < n_new[:, None],
                             top_scores.gather(1, src), float("-inf"))
    return dict(seqs=rows_from(origin_src, token.gather(1, src)),
                scores=new_scores, n_live=n_new, fin_seqs=fin_seqs,
                fin_scores=fin_scores, fin_lens=fin_lens,
                fin_count=fin_count), origin_src


@torch.no_grad()
def beam_decode_packed_kv(teacher, mem_kv, *, max_length: int = 20,
                          beam_size: int = 5, length_penalty: float = 0.6,
                          early_exit: bool = True) -> BeamResult:
    """Beam search for N images over their precomputed head-major
    cross-attention K/V (``precompute_memory_kv``), the beams packed into
    the batch dimension: image n's beams are rows n*K..n*K+K-1 of every
    decoder step, and share its memory K/V as grouped query rows.

    With ``early_exit`` the loop stops once no image has a live beam (one
    host read per step); every later step would be a no-op, since accept and
    finalize are gated on finite scores and dead slots score -inf.

    Returns (seqs (N, K, S) int32 incl. START, length-normalized scores
    (N, K) sorted descending with -inf padding, lens (N, K) int32)."""
    cfg = teacher.cfg
    k0 = mem_kv[0]["k"]
    N, dev, dtype = k0.shape[0], k0.device, k0.dtype
    K, S, V = beam_size, max_length + 1, cfg.vocab_size
    layers = teacher.decoder
    self_kv = TD.init_kv_cache(len(layers), N * K, S, cfg.embed_size, dtype,
                               num_heads=cfg.num_heads, device=dev)
    slots = torch.arange(K, dtype=torch.int32, device=dev)
    neg_inf = float("-inf")
    state = dict(
        seqs=torch.full((N, K, S), PAD, dtype=torch.long, device=dev),
        scores=torch.full((N, K), neg_inf, device=dev),
        n_live=torch.full((N,), K, dtype=torch.long, device=dev),
        fin_seqs=torch.full((N, K, S), PAD, dtype=torch.long, device=dev),
        fin_scores=torch.full((N, K), neg_inf, device=dev),
        fin_lens=torch.zeros((N, K), dtype=torch.long, device=dev),
        fin_count=torch.zeros((N,), dtype=torch.long, device=dev))
    state["seqs"][:, :, 0] = START
    state["scores"][:, 0] = 0.0          # only beam 0 is live at t = 0
    # anc[n, i, s]: the cache slot whose position-s entry belongs to the beam
    # now in slot i
    anc = slots[None, :, None].expand(N, K, S).contiguous()

    for t in range(max_length):
        if early_exit:
            with span("beam.exit_check"):
                if not bool((state["n_live"] > 0).any()):
                    break
        with span("beam.step"):
            with span("beam.decoder"):
                tok = state["seqs"][:, :, t].reshape(N * K)
                x = _teacher_embed_step(teacher, tok, t).to(dtype)
                # this step's rows are written by the current slots
                anc[:, :, t] = slots
                y, self_kv = TD.decoder_step_cached(
                    layers, x, t, self_kv, mem_kv, num_heads=cfg.num_heads,
                    mem_group=K, anc=anc)
                logits = _teacher_logits_step(teacher, y)       # (N*K, V)
            with span("beam.select"):
                logp = torch.log_softmax(logits, dim=-1).reshape(N, K, V)
                cand = state["scores"][:, :, None] + logp      # dead rows -inf
                top_scores, top_idx = torch.topk(cand.reshape(N, K * V), K,
                                                 dim=1)
                state, origin_src = _beam_bookkeeping(
                    state, top_scores, top_idx // V, top_idx % V, t,
                    length_penalty)
                # surviving beams inherit their ancestor's lineage row
                anc = anc.gather(1, origin_src[:, :, None].expand(N, K, S))

    with span("beam.finish"):
        # if nothing finished, the live beams are the result
        ar = torch.arange(K, device=dev)
        live_norm = torch.where(
            ar[None] < state["n_live"][:, None],
            state["scores"] / _length_penalty(S, length_penalty), neg_inf)
        none_finished = (state["fin_count"] == 0)[:, None]
        fin_scores = torch.where(none_finished, live_norm,
                                 state["fin_scores"])
        fin_seqs = torch.where(none_finished[:, :, None], state["seqs"],
                               state["fin_seqs"])
        fin_lens = torch.where(none_finished, S, state["fin_lens"])
        order = torch.argsort(-fin_scores, dim=1, stable=True)
        return (fin_seqs.gather(1, order[:, :, None].expand(N, K, S)
                                ).to(torch.int32),
                fin_scores.gather(1, order),
                fin_lens.gather(1, order).to(torch.int32))


def beam_search_teacher_packed(teacher, memory: torch.Tensor, **kw
                               ) -> BeamResult:
    """N-image beam search, memory (N, L, E) -> (seqs (N, K, S), scores
    (N, K), lens (N, K)): the memory K/V projected once per image, then
    :func:`beam_decode_packed_kv`."""
    with torch.no_grad(), span("beam.memory_kv"):
        mem_kv = TD.precompute_memory_kv(teacher.decoder, memory,
                                         num_heads=teacher.cfg.num_heads)
    return beam_decode_packed_kv(teacher, mem_kv, **kw)


def beam_search_teacher(teacher, memory: torch.Tensor, **kw) -> BeamResult:
    """Single-image beam search, memory (1, L, E) -> (seqs (K, S), scores
    (K,), lens (K,)): the packed search at N = 1."""
    if memory.shape[0] != 1:
        raise ValueError(f"one image at a time; got {memory.shape[0]}")
    seqs, scores, lens = beam_search_teacher_packed(teacher, memory, **kw)
    return seqs[0], scores[0], lens[0]


def beam_search_teacher_batched(teacher, memory: torch.Tensor, **kw
                                ) -> BeamResult:
    """The JAX package's per-image search under ``vmap``; token-identical to
    the packed search by its own test contract, and here a caller of it."""
    return beam_search_teacher_packed(teacher, memory, **kw)


def beam_search_teacher_pipelined(teacher, memory: torch.Tensor, *,
                                  pack: int = 8, **kw) -> BeamResult:
    """Two-stage packed beam: the memory K/V projection at the full batch,
    the decode loop in packs of ``pack`` images.  Token-identical per image
    to :func:`beam_search_teacher_packed` at any pack width (images never
    interact).  memory (B, L, E) with B % pack == 0."""
    B = memory.shape[0]
    if B % pack:
        raise ValueError(f"batch {B} not divisible by pack width {pack}")
    if B == pack:
        return beam_search_teacher_packed(teacher, memory, **kw)
    with torch.no_grad():
        mem_kv = TD.precompute_memory_kv(teacher.decoder, memory,
                                         num_heads=teacher.cfg.num_heads)
    parts = [beam_decode_packed_kv(
        teacher, [{k: v[g:g + pack] for k, v in kv.items()} for kv in mem_kv],
        **kw) for g in range(0, B, pack)]
    return tuple(torch.cat(p) for p in zip(*parts))


# ---------------------------------------------------------------------------
# Host-side detokenization
# ---------------------------------------------------------------------------


def tokens_to_words(tokens, vocab) -> List[str]:
    """(max_len,) decode output -> word list (PAD/START/END stripped)."""
    return vocab.decode(np.asarray(tokens).tolist())


def tokens_to_caption(tokens, vocab) -> str:
    return " ".join(tokens_to_words(tokens, vocab))


def beam_result_to_captions(seqs, scores, vocab, num_return_sequences: int = 1
                            ) -> List[str]:
    """One image's (K, S) hypotheses -> the best ``num_return_sequences``
    strings: START and everything from END on stripped, PAD dropped,
    hypotheses with a non-finite score skipped."""
    outs = []
    seqs, scores = np.asarray(seqs), np.asarray(scores)
    for i in range(min(num_return_sequences, len(seqs))):
        if not np.isfinite(scores[i]):
            continue
        toks = seqs[i].tolist()
        if toks and toks[0] == START:
            toks = toks[1:]
        if END in toks:
            toks = toks[: toks.index(END)]
        toks = [t for t in toks if t != PAD]
        outs.append(" ".join(vocab.itos.get(t, "<UNK>") for t in toks))
    return outs
