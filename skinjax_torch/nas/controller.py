"""The REINFORCE LSTM controller (counterpart of ``skinjax/nas/controller.py``;
controllerMultimodalmodel.py:5-51) and its policy-gradient search loop.

One LSTM step per search-space key; a Linear head over the hidden state
gives that key's categorical logits; the chosen index's embedding is the
next step's input; a learned start token seeds the chain. Sampling (no
gradient) and scoring (log-probability and entropy of given indices, the
REINFORCE surrogate) are separate passes, as in skinjax.

The search runs on the device it is given (the train config's), sampling
from an explicit ``torch.Generator`` there. Its update is skinjax's optax
chain: the gradient clipped to a global norm as optax computes it
(``g · max_norm / ‖g‖`` when ‖g‖ ≥ max_norm, no epsilon), then Adam.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import torch
from torch import nn

from skinjax_torch.nas.dynamic_model import lecun_init
from skinjax_torch.nas.search_space import indices_to_config


class Controller(nn.Module):
    def __init__(self, search_space_sizes: Sequence[Tuple[str, int]], hidden_size: int = 256):
        super().__init__()
        self.search_space_sizes = tuple((k, int(n)) for k, n in search_space_sizes)
        self.hidden_size = hidden_size
        self.lstm = nn.LSTMCell(hidden_size, hidden_size)
        # flax's input Denses have no bias: torch's bias_ih stays zero (a
        # trained bias_ih would double every bias step)
        self.lstm.bias_ih.requires_grad_(False)
        self.heads = nn.ModuleDict({k: nn.Linear(hidden_size, n)
                                    for k, n in self.search_space_sizes})
        self.embeds = nn.ModuleDict({k: nn.Embedding(n, hidden_size)
                                     for k, n in self.search_space_sizes})
        self.start_token = nn.Parameter(torch.empty(1, hidden_size))

    def _chain(self, choose):
        h = torch.zeros_like(self.start_token)
        carry = (h, h)
        x = self.start_token
        for name, _ in self.search_space_sizes:
            carry = self.lstm(x, carry)
            idx = choose(name, self.heads[name](carry[0])[0])
            x = self.embeds[name](idx.reshape(1))

    def score(self, indices: Mapping[str, int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sum of log-probabilities, sum of entropies) of the given choice
        indices; differentiable in the parameters."""
        out = {"log_prob": 0.0, "entropy": 0.0}

        def choose(name, logits):
            logp = torch.log_softmax(logits, dim=-1)
            idx = torch.as_tensor(int(indices[name]), device=logits.device)
            out["log_prob"] = out["log_prob"] + logp[idx]
            out["entropy"] = out["entropy"] - (logp.exp() * logp).sum()
            return idx

        self._chain(choose)
        return out["log_prob"], out["entropy"]

    @torch.no_grad()
    def sample(self, generator: torch.Generator) -> Dict[str, int]:
        """One architecture's choice indices, drawn autoregressively."""
        indices: Dict[str, int] = {}

        def choose(name, logits):
            idx = torch.multinomial(torch.softmax(logits, dim=-1), 1, generator=generator)[0]
            indices[name] = int(idx)
            return idx

        self._chain(choose)
        return indices


@torch.no_grad()
def clip_by_global_norm(params: Sequence[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm on the parameters' gradients, in place."""
    grads = [p.grad for p in params]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


class ReinforceSearch:
    """EMA-baseline REINFORCE search (optimization_train_process_pad_20.py:
    275-373): loss = -(reward - baseline)·logπ - β·entropy, Adam(1e-3), the
    gradient clipped to a global norm."""

    def __init__(
        self,
        search_space: Dict[str, Sequence],
        hidden_size: int = 256,
        controller_lr: float = 1e-3,
        entropy_beta: float = 0.01,
        grad_clip_norm: float = 1.0,
        seed: int = 0,
        device="cuda",
    ):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the controller's device is cuda but CUDA is not available; "
                               "pass device='cpu' to search on the CPU")
        self.search_space = {k: list(v) for k, v in search_space.items()}
        sizes = tuple((k, len(v)) for k, v in self.search_space.items())
        model = lecun_init(Controller(sizes, hidden_size), seed)
        with torch.no_grad():  # flax's start token: normal(1.0)
            g = torch.Generator().manual_seed(seed + 1)
            model.start_token.copy_(torch.randn(model.start_token.shape, generator=g))
        self.model = model.to(device)
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = torch.optim.Adam(self.params, lr=controller_lr)
        self.entropy_beta = entropy_beta
        self.grad_clip_norm = grad_clip_norm
        self.baseline = None
        self.best_reward = -float("inf")
        self.best_config = None
        self.history: List[Dict] = []

    def sample_config(self) -> Tuple[Dict, Dict[str, int]]:
        """Autoregressively sample one architecture config."""
        indices = self.model.sample(self.generator)
        return indices_to_config(indices, self.search_space), indices

    def update(self, indices: Dict[str, int], reward: float) -> Dict[str, float]:
        """One REINFORCE step on the sampled config's observed reward."""
        self.baseline = (
            reward if self.baseline is None else 0.5 * self.baseline + 0.5 * reward
        )
        advantage = reward - self.baseline
        logp, ent = self.model.score(indices)
        loss = -advantage * logp - self.entropy_beta * ent
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for p in self.params:  # jax.grad's zero for the unread last embedding
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        clip_by_global_norm(self.params, self.grad_clip_norm)
        self.optimizer.step()
        ent, loss = float(ent.detach()), float(loss.detach())

        if reward > self.best_reward:
            self.best_reward = reward
            self.best_config = indices_to_config(indices, self.search_space)
        self.history.append(
            {"reward": reward, "baseline": self.baseline, "advantage": advantage,
             "entropy": ent, "loss": loss}
        )
        return {"loss": loss, "entropy": ent,
                "baseline": float(self.baseline)}
