"""Plain-PyTorch oracles of the reference models in the reference's flat
data layout: the flagship hybrid (``torch_ref.py``) and the six baseline
GNNs (``torch_ref_gnn.py``).  Their ``state_dict``s are the reference's
checkpoint format, which ``compat.py`` reads and writes.  Beside them,
the host-side harnesses: the classical-ML model sweep
(``classical.py``) and the descriptor statistics study (``stats.py``)."""

__all__ = []
