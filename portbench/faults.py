"""Faults planted under the timed path, for the tests that show a broken
program comes out not correct and for the readings that set the limits
(``calibrate.py``).  Each is a context manager that replaces one function
of the port and puts it back."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def stale_state():
    """The KD step returns its state unchanged: AdamW updates nothing."""
    from imagecaptioner_tpu_torch.train import optim
    return _patched(optim, "adamw_update", lambda f: lambda *a, **k: None)


def half_batch():
    """The KD loss of each micro-batch over its first half of rows only."""
    from imagecaptioner_tpu_torch.train import steps

    def make(f):
        def loss(optimized, cfg, s_out, t_out, targets, lengths, epoch):
            h = targets.shape[1] // 2
            s_out = dict(s_out, logits=s_out["logits"][:, :h],
                         encoder_features=s_out["encoder_features"][:h],
                         hidden_states=s_out["hidden_states"][:, :h])
            t_out = dict(t_out, logits=t_out["logits"][:, :h],
                         encoder_features=t_out["encoder_features"][:h])
            return f(optimized, cfg, s_out, t_out, targets[:, :h],
                     lengths[:h], epoch)
        return loss
    return _patched(steps, "_kd_loss", make)


def altered_token():
    """Greedy serving alters each row's first token where it is produced."""
    from imagecaptioner_tpu_torch.eval import serve

    def make(f):
        def decode(student, feats, cfg, **kw):
            toks = f(student, feats, cfg, **kw).clone()
            toks[:, 0] = 4 + (toks[:, 0] + 1) % (cfg.vocab_size - 4)
            return toks
        return decode
    return _patched(serve, "best_greedy_decode_student", make)


def _one_row(make_row):
    """Greedy serving with one slot of every batch changed by
    ``make_row(tokens, row, vocab_size)`` where it is produced."""
    from imagecaptioner_tpu_torch.eval import serve

    def make(f):
        def decode(student, feats, cfg, **kw):
            toks = f(student, feats, cfg, **kw).clone()
            row = feats.shape[0] // 3
            toks[row] = make_row(toks, row, cfg.vocab_size)
            return toks
        return decode
    return _patched(serve, "best_greedy_decode_student", make)


def altered_row():
    """Every served word of one slot of every batch altered."""
    def row(toks, r, V):
        t = toks[r]
        return torch.where(t > 0, 4 + (t + 1) % (V - 4), t)
    return _one_row(row)


def swapped_row():
    """One slot of every batch served the next slot's caption."""
    return _one_row(lambda toks, r, V: toks[(r + 1) % toks.shape[0]])


def half_batch_greedy():
    """Greedy serving decodes the first half of the batch; the rest of the
    rows come back empty."""
    from imagecaptioner_tpu_torch.eval import serve

    def make(f):
        def decode(student, feats, cfg, **kw):
            h = feats.shape[0] // 2
            toks = f(student, feats[:h].contiguous(), cfg, **kw)
            return torch.cat([toks, torch.zeros_like(toks)])[:feats.shape[0]]
        return decode
    return _patched(serve, "best_greedy_decode_student", make)


def altered_beam_token():
    """Beam serving alters every hypothesis's first word where it is
    produced."""
    from imagecaptioner_tpu_torch.eval import serve

    def make(f):
        def search(teacher, memory, **kw):
            seqs, scores, lens = f(teacher, memory, **kw)
            seqs = seqs.clone()
            V = teacher.cfg.vocab_size
            seqs[:, :, 1] = 4 + (seqs[:, :, 1] + 1) % (V - 4)
            return seqs, scores, lens
        return search
    return _patched(serve, "beam_search_teacher_packed", make)


def half_batch_beam():
    """Beam serving searches the first half of the batch; the other images
    get no hypothesis."""
    from imagecaptioner_tpu_torch.eval import serve

    def make(f):
        def search(teacher, memory, **kw):
            h = memory.shape[0] // 2
            seqs, scores, lens = f(teacher, memory[:h], **kw)
            return (torch.cat([seqs, torch.zeros_like(seqs)]),
                    torch.cat([scores, torch.full_like(scores,
                                                       float("-inf"))]),
                    torch.cat([lens, torch.zeros_like(lens)]))
        return search
    return _patched(serve, "beam_search_teacher_packed", make)


class _TopkPastTheBest:
    """``torch`` for one module, whose ``topk`` returns the candidates
    ranked 2 to k + 1: a search that keeps the wrong beams."""

    def __init__(self, torch_module):
        self._torch = torch_module

    def __getattr__(self, name):
        return getattr(self._torch, name)

    def topk(self, x, k, dim=-1, **kw):
        s, i = self._torch.topk(x, k + 1, dim=dim, **kw)
        return s.narrow(dim, 1, k), i.narrow(dim, 1, k)


def wrong_beams():
    """Beam search keeps the candidates ranked 2 to K + 1 at every step;
    the scores it returns are those of the tokens it kept."""
    from imagecaptioner_tpu_torch.ops import decode
    return _patched(decode, "torch", _TopkPastTheBest)


def reversed_ranking():
    """Beam serving returns each image's hypotheses worst first."""
    from imagecaptioner_tpu_torch.eval import serve

    def make(f):
        def search(teacher, memory, **kw):
            return tuple(t.flip(1) for t in f(teacher, memory, **kw))
        return search
    return _patched(serve, "beam_search_teacher_packed", make)


FAULTS = {"stale_state": stale_state, "half_batch": half_batch,
          "altered_token": altered_token,
          "half_batch_greedy": half_batch_greedy,
          "altered_row": altered_row, "swapped_row": swapped_row,
          "altered_beam_token": altered_beam_token,
          "half_batch_beam": half_batch_beam, "wrong_beams": wrong_beams,
          "reversed_ranking": reversed_ranking}
