"""Contact events: started / persisted / ended pair sets.

Starframe exposes contact events from its tick (SURVEY.md §2 row 3.2 step 6
[K-med]). Here ``step(..., with_contacts=True)`` returns the frame's
:class:`~starframe_tpu.contacts.Contacts`; this module diffs consecutive
frames into event sets — on device (fixed-size masks) or on host (python
sets of collider-index pairs).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .contacts import Contacts


def touching_keys(contacts: Contacts, n_colliders: int):
    """Device-side canonical pair keys [P] + touching mask.

    Packs ``(min, max)`` collider indices into one int32 as
    ``a * n_colliders + b``. An int64 shift-pack would silently truncate
    under JAX's default x64-disabled mode (the ``a << 32`` bits vanish and
    keys collapse to ``b``), so the static collider capacity is required.
    """
    a = jnp.minimum(contacts.collider_a, contacts.collider_b).astype(jnp.int32)
    b = jnp.maximum(contacts.collider_a, contacts.collider_b).astype(jnp.int32)
    return a * jnp.int32(n_colliders) + b, contacts.touching


def diff_contacts(prev: Contacts | None, cur: Contacts):
    """Host-side event sets: (started, persisted, ended), each a set of
    ``(collider_a, collider_b)`` tuples with a < b."""

    def to_set(c):
        if c is None:
            return set()
        ca = np.asarray(c.collider_a)
        cb = np.asarray(c.collider_b)
        t = np.asarray(c.touching)
        return {
            (int(min(a, b)), int(max(a, b)))
            for a, b, touch in zip(ca, cb, t)
            if touch
        }

    p = to_set(prev)
    q = to_set(cur)
    return q - p, q & p, p - q


class ContactEvents:
    """Stateful helper mirroring starframe's contact-event readout: feed the
    per-frame Contacts, read ``.started`` / ``.ended`` / ``.touching``."""

    def __init__(self):
        self._prev: Contacts | None = None
        self.started: set = set()
        self.persisted: set = set()
        self.ended: set = set()

    def update(self, contacts: Contacts):
        self.started, self.persisted, self.ended = diff_contacts(self._prev, contacts)
        self._prev = contacts
        return self

    @property
    def touching(self) -> set:
        return self.started | self.persisted


def key_event_masks(prev_keys, cur_keys):
    """Device-side started/ended masks between consecutive frames' canonical
    key tables (any shape; -1 marks empty slots) — the on-device analogue of
    :func:`diff_contacts` for batched rollouts
    (:func:`starframe_tpu.parallel.batched_step_events`).

    ``started[i] = cur_keys[i] >= 0 and cur_keys[i] not in prev_keys`` and
    symmetrically for ``ended``. Duplicate keys simply produce the same
    mask value twice; reduce to sets downstream when uniqueness matters."""
    p = jnp.sort(prev_keys.reshape(-1))
    c = jnp.sort(cur_keys.reshape(-1))

    def in_sorted(arr, q):
        i = jnp.clip(jnp.searchsorted(arr, q), 0, arr.shape[0] - 1)
        return arr[i] == q

    started = (cur_keys >= 0) & ~in_sorted(p, cur_keys)
    ended = (prev_keys >= 0) & ~in_sorted(c, prev_keys)
    return started, ended


def keys_to_set(keys, n_colliders: int) -> set:
    """Host-side set of ``(collider_a, collider_b)`` tuples from a canonical
    key table (-1 entries skipped)."""
    k = np.unique(np.asarray(keys).reshape(-1))
    k = k[k >= 0]
    return {(int(x) // n_colliders, int(x) % n_colliders) for x in k}
