"""Sessionized traffic source: appends impression/click events to the log.
A copy of the JAX package's ``stream/source.py`` (numpy): the same seed
gives the same sessions, events and payloads.

Models the paper's serving-side traffic shape: users arrive in sessions,
each session emits a burst of impressions over zipfian-skewed items, and
a fraction convert to clicks (hot items click more).  Event keys are
user ids, so one user's events land in one partition in order — the
per-key ordering the profile updater depends on.
"""
from __future__ import annotations

import numpy as np

from repro_torch.stream.log import Event, EventLog


class SessionizedSource:
    """Seeded generator of impression/click events.

    ``emit_session()`` appends one user session's events and returns
    them; the caller (launcher thread) controls pacing.  Deterministic
    for a given seed, so tests can replay identical traffic.
    """

    def __init__(self, log: EventLog, topic: str, *,
                 n_users: int, n_items: int, seed: int = 0,
                 session_len: int = 8, zipf_a: float = 1.2,
                 click_rate: float = 0.3):
        self.log = log
        self.topic = topic
        self.n_users = int(n_users)
        self.n_items = int(n_items)
        self.session_len = int(session_len)
        self.click_rate = float(click_rate)
        self._rng = np.random.default_rng(seed)
        # zipfian item popularity, fixed per source: item 0 hottest
        ranks = np.arange(1, self.n_items + 1, dtype=np.float64)
        w = ranks ** -float(zipf_a)
        self._item_p = w / w.sum()
        self.sessions_emitted = 0
        self.events_emitted = 0

    def pick_user(self) -> int:
        return int(self._rng.integers(0, self.n_users))

    def emit_session(self, user: int | None = None) -> list[Event]:
        """Append one session (impressions + clicks) for one user."""
        if user is None:
            user = self.pick_user()
        n = 1 + int(self._rng.integers(0, self.session_len))
        items = self._rng.choice(self.n_items, size=n, p=self._item_p)
        clicks = self._rng.random(n) < self.click_rate
        out: list[Event] = []
        for item, clicked in zip(items, clicks):
            out.append(self.log.append(
                self.topic, int(user), "impression", {"item": int(item)}))
            if clicked:
                out.append(self.log.append(
                    self.topic, int(user), "click", {"item": int(item)}))
        self.sessions_emitted += 1
        self.events_emitted += len(out)
        return out
