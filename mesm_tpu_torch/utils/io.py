"""Small host IO helpers (reference utils/func_utils.py)."""
from __future__ import annotations

import json
import os


def mkdirp(p: str):
    os.makedirs(p, exist_ok=True)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def save_json(data, path: str, save_pretty: bool = False, sort_keys: bool = False):
    with open(path, "w") as f:
        if save_pretty:
            f.write(json.dumps(data, indent=4, sort_keys=sort_keys, default=str))
        else:
            json.dump(data, f, default=str)


def load_jsonl(path: str):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def save_jsonl(data, path: str):
    with open(path, "w") as f:
        f.write("\n".join(json.dumps(e) for e in data))


def dict_to_markdown(d: dict, max_str_len: int = 120) -> str:
    rows = []
    for k, v in d.items():
        s = repr(v) if isinstance(v, list) else str(v)
        if max_str_len is not None and len(s) > max_str_len:
            s = s[-max_str_len:]
        rows.append(f"| {k} | {s} |")
    return "\n".join(["| key | value |", "|---|---|"] + rows)
