"""XAI suite: the CAM family, the metadata perturbation analyses and the
tabular explainers (counterpart of ``skinjax/xai``, the same ``__all__``)."""

from skinjax_torch.xai.cam import (
    cam_methods_comparison,
    grad_cam,
    grad_cam_pp,
    overlay_heatmap,
    score_cam,
)
from skinjax_torch.xai.perturbation import (
    Mutation,
    default_pad20_mutations,
    entropy,
    faithfulness_degradation_score,
    js_divergence,
    kl_divergence,
    missing_data_sweep,
    prediction_uncertainty,
    run_flip_analysis,
    simulate_missing_metadata,
)
from skinjax_torch.xai.tabular import (
    kernel_shap,
    lime_tabular,
    lime_tabular_categorical,
    permutation_importance,
)

__all__ = [
    "cam_methods_comparison",
    "grad_cam",
    "grad_cam_pp",
    "overlay_heatmap",
    "score_cam",
    "Mutation",
    "default_pad20_mutations",
    "entropy",
    "faithfulness_degradation_score",
    "js_divergence",
    "kl_divergence",
    "missing_data_sweep",
    "prediction_uncertainty",
    "run_flip_analysis",
    "simulate_missing_metadata",
    "kernel_shap",
    "lime_tabular",
    "lime_tabular_categorical",
    "permutation_importance",
]
