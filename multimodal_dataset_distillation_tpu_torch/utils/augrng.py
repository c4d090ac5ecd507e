"""Thread-local RNG for host-side augmentation draws.

The port's own copy of ``multimodal_dataset_distillation_tpu/utils/augrng.py``
(its thread-local state is this module's, not the JAX package's).

The reference's augmentations draw from process-global RNG streams
(numpy/random seeded ad hoc — ``utils.py:149`` even seeds from the wall
clock), which makes augmented batches irreproducible and, under our
threaded ``Loader``, racy: legacy ``np.random`` mt19937 state is not
thread-safe, and even when it survives, the draw ORDER depends on
thread scheduling — two runs with the same ``--seed`` produced
different expert trajectories.

Fix: augmentation code draws from :func:`get` — a thread-local
``RandomState`` that the ``Loader`` (and ``get_images_texts``) seeds
PER ITEM from ``SeedSequence([loader_seed, epoch, dataset_index])``.
Augments become a pure function of (seed, epoch, index): deterministic
under any thread schedule, identical across multi-host processes
fetching the same global index, and thread-safe (each worker thread has
its own state).  When no per-item seed is installed (direct transform
calls, unseeded loaders, tests that seed ``np.random`` globally),
:func:`get` falls back to the legacy global ``np.random`` module, so
existing seeded-by-global-stream behavior is unchanged.
"""

from __future__ import annotations

import threading

import numpy as np

_TLS = threading.local()


def get():
    """The RNG augmentations must draw from (RandomState or np.random)."""
    rng = getattr(_TLS, "rng", None)
    return rng if rng is not None else np.random


def seed_item(*entropy) -> None:
    """Install a fresh thread-local RandomState derived from ``entropy``
    (well-mixed via SeedSequence — adjacent (seed, epoch, index) tuples
    give independent streams)."""
    ss = np.random.SeedSequence([int(e) & 0x7FFFFFFF for e in entropy])
    _TLS.rng = np.random.RandomState(ss.generate_state(1)[0])


def clear() -> None:
    """Back to the legacy global np.random stream for this thread."""
    _TLS.rng = None
