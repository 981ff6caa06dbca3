"""hymba-1.5b's dry-run steps at ``reduced()`` size, as
``test_torch_dryrun_trace.py`` traces the other archs: train_4k, decode_32k
and long_500k here, prefill_32k in ``test_torch_dryrun_trace_hybrid_prefill.py``.
Its Mamba scan runs chunk by chunk (16 positions a chunk, each recomputed in
the backward), so a trace takes minutes here: the two files let two test
workers share them."""
from test_torch_dryrun_trace import trace_every_shape


def test_reduced_hymba_traces_train_and_decode(monkeypatch):
    trace_every_shape("hymba-1.5b", monkeypatch, ("train_4k", "decode_32k", "long_500k"))
