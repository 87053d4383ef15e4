"""Contact information wrapper (the port's copy of ``mmdyn_tpu/sim/contact.py``;
port of mmdyn/tact_sim/tactile/contact.py).

Queries the physics backend for contacts on a body and drops ground contacts
(body id 0), exposing per-body total normal force.
"""

from __future__ import annotations

import numpy as np


class Contact:
    def __init__(self, base_body_id, backend):
        self._body_ids = []
        self._points = []
        self._normal_forces = []
        for c in backend.contacts(base_body_id):
            # drop contacts with the ground (contact.py:36-40)
            if c.body_b != 0:
                self._body_ids.append(c.body_b)
                self._points.append(list(c.position))
                self._normal_forces.append(c.normal_force)

    def __len__(self):
        return len(self._body_ids)

    def total_force(self, body_id):
        """Total normal force on one body (contact.py:45-54)."""
        info = self.info
        return float(info["normal_forces"][
            np.where(info["body_ids"] == body_id)].sum())

    @property
    def unique_ids(self):
        return list(set(self._body_ids))

    @property
    def info(self):
        return {
            "body_ids": np.reshape(self._body_ids, (-1, 1)),
            "points": np.reshape(self._points, (-1, 3)),
            "normal_forces": np.reshape(self._normal_forces, (-1, 1)),
        }
