"""NAS / HPO (counterpart of ``skinjax.nas``): search space, DynamicCNN, the
masked supernet and its population trainer, REINFORCE controller, GP Bayesian
optimization, LLM-as-controller, search and retrain loops."""

from skinjax_torch.nas.bayes_opt import GPSearch
from skinjax_torch.nas.controller import Controller, ReinforceSearch
from skinjax_torch.nas.dynamic_model import DynamicCNN, make_dynamic_model
from skinjax_torch.nas.llm_controller import LLMSearch, build_prompt, make_config_validator
from skinjax_torch.nas.population import PopulationTrainer, make_population_evaluator
from skinjax_torch.nas.search import retrain_best, run_nas
from skinjax_torch.nas.supernet import (
    Envelope,
    SuperNet,
    candidate_masks,
    embed_params,
    envelope_of,
)
from skinjax_torch.nas.search_space import (
    DEFAULT_SEARCH_SPACE,
    config_to_indices,
    filters_from_config,
    indices_to_config,
)

__all__ = [
    "GPSearch",
    "Controller",
    "ReinforceSearch",
    "DynamicCNN",
    "make_dynamic_model",
    "LLMSearch",
    "build_prompt",
    "make_config_validator",
    "PopulationTrainer",
    "make_population_evaluator",
    "retrain_best",
    "run_nas",
    "Envelope",
    "SuperNet",
    "candidate_masks",
    "embed_params",
    "envelope_of",
    "DEFAULT_SEARCH_SPACE",
    "config_to_indices",
    "filters_from_config",
    "indices_to_config",
]
