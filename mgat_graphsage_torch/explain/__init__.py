"""Interpretability: gradient + GNNExplainer node importance, stratified
sampling, substructure mapping, figures, and the 4-stage pipeline (port of
``mgat_graphsage_tpu/explain``).  Importing it imports no matplotlib: the
figure suite (``figures.py``) loads only when figures are made."""

from .gradients import (
    make_gradient_explainer,
    make_scan_gradient_explainer,
    process_node_importance,
    process_node_importance_batch,
)
from .gnnexplainer import make_gnn_explainer, make_scan_gnn_explainer
from .sampling import (
    qcut_bins,
    select_representative_molecules,
    stratified_sample_by_column,
)
from .smarts import find_matches, has_match, parse_smarts
from .substructures import (
    COMMON_SUBSTRUCTURES,
    SubstructureIdentifier,
    analyze_full_dataset_substructures,
    find_important_substructures,
)
from .pipeline import hybrid_analysis_strategy, quick_importance_analysis_all

__all__ = [
    "make_gradient_explainer", "make_scan_gradient_explainer",
    "process_node_importance", "process_node_importance_batch",
    "make_gnn_explainer", "make_scan_gnn_explainer",
    "qcut_bins", "select_representative_molecules",
    "stratified_sample_by_column", "find_matches", "has_match",
    "parse_smarts", "COMMON_SUBSTRUCTURES", "SubstructureIdentifier",
    "analyze_full_dataset_substructures", "find_important_substructures",
    "hybrid_analysis_strategy", "quick_importance_analysis_all",
]
