"""Share of the untraced window in the program's ``predict.upload`` span:
``predict_dataset``'s uploads of the dataset and its index arrays
(``eval/predict.py``). Host seconds, summed over the ``predict_call``
units of ``utils/telemetry.py`` that closed after the newest profiled one
(the traced part of a ``--trace 1`` run comes first), over the window;
nothing where their number is not the window's calls (``molecules`` over
the mix's ``chunk``) or the program has no such registry."""


def read(r):
    try:
        from mgat_graphsage_torch.utils import telemetry
    except ImportError:
        return None
    window = r.counters.get("window_s")
    chunk = r.traffic.get("chunk")
    units = telemetry.unprofiled_tail("predict_call")
    if not window or not units or not chunk or \
            r.counters.get("molecules") != len(units) * chunk:
        return None
    seconds = sum(u.spans.get("predict.upload", 0.0) for u in units)
    return 100.0 * seconds / window
