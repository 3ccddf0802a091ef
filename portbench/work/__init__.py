"""Operations and bytes of each layer, from a configuration's shapes.

A multiply-add counts as two operations.  Bytes count each input read once
and each output written once (weights included), whatever a kernel reads
again.  The rooflines and ``mfu`` read their work here and their time from
the trace or the window.
"""
