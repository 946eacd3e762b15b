"""CachingLM — persistent response cache around any LM.

Port of the reference's sqlite response cache (`lm_eval/base.py:784-841`,
via sqlitedict): identical semantics (hash on request type + args, partial
hits executed and backfilled), plain stdlib sqlite3 instead of sqlitedict.
"""

from __future__ import annotations

import hashlib
import json
import os
import sqlite3
from typing import List

from .base import LM


class CachingLM:
    def __init__(self, lm: LM, cache_db: str):
        self.lm = lm
        os.makedirs(os.path.dirname(cache_db) or ".", exist_ok=True)
        self.conn = sqlite3.connect(cache_db)
        self.conn.execute(
            "CREATE TABLE IF NOT EXISTS cache (key TEXT PRIMARY KEY, value TEXT)"
        )
        self.conn.commit()

    @staticmethod
    def _key(attr: str, args) -> str:
        raw = json.dumps([attr, list(args)], sort_keys=True, default=str)
        return hashlib.sha256(raw.encode()).hexdigest()

    def _get(self, key: str):
        row = self.conn.execute("SELECT value FROM cache WHERE key=?", (key,)).fetchone()
        return None if row is None else json.loads(row[0])

    def _put(self, key: str, value) -> None:
        self.conn.execute(
            "INSERT OR REPLACE INTO cache (key, value) VALUES (?, ?)",
            (key, json.dumps(value)),
        )

    def __getattr__(self, attr: str):
        if attr not in ("loglikelihood", "loglikelihood_rolling", "greedy_until"):
            return getattr(self.lm, attr)

        def fn(requests) -> List:
            res = []
            remaining_reqs = []
            for req in requests:
                key = self._key(attr, req if isinstance(req, (list, tuple)) else (req,))
                hit = self._get(key)
                res.append(hit)  # None marks a miss
                if hit is None:
                    remaining_reqs.append(req)
            new_res = getattr(self.lm, attr)(remaining_reqs) if remaining_reqs else []
            it = iter(new_res)
            for i, r in enumerate(res):
                if r is None:
                    val = next(it)
                    val = list(val) if isinstance(val, tuple) else val
                    res[i] = val
                    req = requests[i]
                    key = self._key(attr, req if isinstance(req, (list, tuple)) else (req,))
                    self._put(key, val)
            self.conn.commit()
            # loglikelihood returns (ll, is_greedy) tuples
            if attr == "loglikelihood":
                return [tuple(r) for r in res]
            return res

        return fn
