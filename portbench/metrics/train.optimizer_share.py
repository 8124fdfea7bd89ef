"""Share of the untraced window in the program's ``train.optimizer`` span:
``Trainer.train_step``'s ``set_lr`` and optimizer step. Host seconds,
summed over the ``train_epoch`` units of ``utils/telemetry.py`` that
closed after the newest profiled one (the traced part of a ``--trace 1``
run comes first), over the window; nothing where their number is not the
window's epochs or the program has no such registry."""


def read(r):
    try:
        from mgat_graphsage_torch.utils import telemetry
    except ImportError:
        return None
    window = r.counters.get("window_s")
    units = telemetry.unprofiled_tail("train_epoch")
    if not window or not units or len(units) != r.counters.get("epochs"):
        return None
    seconds = sum(u.spans.get("train.optimizer", 0.0) for u in units)
    return 100.0 * seconds / window
