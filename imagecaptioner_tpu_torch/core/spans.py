"""Named spans at the port's layer boundaries, on the profiler's clock.

``with span("beam.select"): ...`` opens ``torch.profiler.record_function(
"ic:beam.select")`` while a ``torch.profiler`` session records, and does
nothing otherwise.  The range is a ``user_annotation`` event of the same
Chrome trace as the device's kernels, copies and fills, so a trace reader
can give each device operation the spans its launch lies in; nesting gives
each span its parent, and the outermost span of a call or step
(``serve.call``, ``kd.step``) tells one call from the next.  The profiler
keeps the spans and exports them with its trace: nothing is stored here.

Without a profiler a span costs one check of the profiler's state and
returns one shared null context (well under a microsecond on a CPU, where a
bare ``record_function`` costs about 13 µs).  Spans sit at layer
boundaries, never around single kernel launches: at most about a hundred
a call or step.

``NAMES`` lists every span of the package; a trace reader matches a name
as a substring, so no name is part of another.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["NAMES", "PREFIX", "span"]

PREFIX = "ic:"

NAMES = (
    # eval/serve.py: the greedy and beam captioners' call
    "serve.call", "serve.upload", "serve.encode", "serve.decode",
    "serve.fetch",
    # ops/decode.py: the packed beam search
    "beam.memory_kv", "beam.exit_check", "beam.step", "beam.decoder",
    "beam.select", "beam.finish",
    # train/steps.py: the KD step and its feed
    "kd.feed", "kd.step", "kd.augment", "kd.teacher", "kd.student",
    "kd.loss", "kd.backward", "kd.optimizer",
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: the profiler's range ``"ic:" + name`` while a
    profiler records, else a shared null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF
