"""Share of the untraced training window that the device spends summing
the graph transformer's structural bias tables' gradients: the
``graphormer.bias_grad`` device span (``ops/structural_bias.py``, the
bias kernels' backward, once a training step) summed over the
``train_epoch`` units of ``utils/telemetry.py`` that closed after the
newest profiled one, over the window.  Nothing where their number is not
the window's epochs, or the program opens no such span (a program whose
bias backward is autograd's)."""


def read(r):
    try:
        from mgat_graphsage_torch.utils import telemetry
    except ImportError:
        return None
    window, epochs = r.counters.get("window_s"), r.counters.get("epochs")
    if not window or not epochs:
        return None
    units = telemetry.unprofiled_tail("train_epoch")
    if len(units) != epochs:
        return None
    spans = [getattr(u, "device", None) for u in units]
    if any(s is None or "graphormer.bias_grad" not in s for s in spans):
        return None
    return 100.0 * sum(s["graphormer.bias_grad"] for s in spans) / window
