"""hymba-1.5b's prefill_32k dry-run step at ``reduced()`` size (the rest of
its steps: ``test_torch_dryrun_trace_hybrid.py``)."""
from test_torch_dryrun_trace import trace_every_shape


def test_reduced_hymba_traces_prefill(monkeypatch):
    trace_every_shape("hymba-1.5b", monkeypatch, ("prefill_32k",))
