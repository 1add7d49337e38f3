"""Adam (Kingma and Ba, 2015) in plain PyTorch: bias-corrected moments,
epsilon added to the square root, the update subtracted times the learning
rate. float32 state."""

from __future__ import annotations

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


class Adam:
    def __init__(self, params: dict[str, torch.Tensor], lr: float):
        self.lr, self.t = lr, 0
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor],
             grads: dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1.0 - B1 ** self.t, 1.0 - B2 ** self.t
        for n, g in grads.items():
            mu, nu = self.mu[n], self.nu[n]
            mu.mul_(B1).add_(g, alpha=1.0 - B1)
            nu.mul_(B2).addcmul_(g, g, value=1.0 - B2)
            params[n].sub_(self.lr * (mu / c1) / ((nu / c2).sqrt() + EPS))
