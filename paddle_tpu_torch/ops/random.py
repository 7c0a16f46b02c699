"""The port's random generator (mirror of ``paddle_tpu/ops/random.py``'s
``Generator``, ``default_generator``, ``seed``, ``get_rng_state`` and
``set_rng_state``).

The JAX package folds a counter into one root key.  Here a ``Generator``
holds an explicit ``torch.Generator`` for each device it has drawn on,
each seeded from the one seed when first used, so a draw never touches
PyTorch's global generators.  Dropout draws its masks from
``default_generator()``.  The bits differ from ``jax.random``'s; a seed
still fixes every mask.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch

_state = threading.local()


class Generator:
    def __init__(self, seed_val: int = 0):
        self._seed = int(seed_val)
        self._gens: Dict[torch.device, torch.Generator] = {}

    def manual_seed(self, seed_val: int) -> "Generator":
        self._seed = int(seed_val)
        self._gens.clear()
        return self

    def generator(self, device) -> torch.Generator:
        """The ``torch.Generator`` that draws on ``device``."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        gen = self._gens.get(dev)
        if gen is None:
            gen = self._gens[dev] = torch.Generator(device=dev).manual_seed(
                self._seed)
        return gen

    def get_state(self) -> Tuple[int, Dict[str, torch.Tensor]]:
        """(seed, {device: state of its generator})."""
        return self._seed, {str(d): g.get_state()
                            for d, g in self._gens.items()}

    def set_state(self, state) -> None:
        seed_val, states = state
        self.manual_seed(seed_val)
        for dev, st in states.items():
            self.generator(dev).set_state(st)


def default_generator() -> Generator:
    if not hasattr(_state, "gen"):
        _state.gen = Generator(0)
    return _state.gen


def seed(seed_val: int) -> None:
    """Mirror of ``paddle.seed``: reseed the default generator."""
    default_generator().manual_seed(int(seed_val))


def get_rng_state():
    return default_generator().get_state()


def set_rng_state(state) -> None:
    default_generator().set_state(state)


def bernoulli(keep_prob: float, shape, device) -> torch.Tensor:
    """A bool mask of ``shape`` on ``device``, each entry True with
    probability ``keep_prob``, drawn from the default generator (the
    counterpart of ``jax.random.bernoulli`` with the generator's next
    key)."""
    gen = default_generator().generator(device)
    return torch.rand(tuple(shape), generator=gen, device=device) < keep_prob
