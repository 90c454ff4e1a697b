"""What every cell's run shares: the files a cell is made of, the measured
program's options and model, the set-up clock, the per-layer readers, and
the result line.

A cell is `cells/<cell>.json`: its configuration (`configs/<config>.json`),
its traffic mix (`traffic/<mix>.json`), its driver (`drivers/<driver>.py`),
its end-to-end and per-layer metrics (each per-layer metric a reader
`metrics/<metric>.py`) and the limits of its correctness check.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules that may never be loaded in a run: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "mesm_tpu")


def load(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(name: str):
    import importlib

    return importlib.import_module(f"portbench.drivers.{name}")


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among `names` (the loaded modules by
    default), each compared whole: `mesm_tpu_torch` is not `mesm_tpu`."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


@dataclass
class Run:
    cell_name: str
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start: float = 0.0
    fault: Optional[str] = None
    overrides: dict = field(default_factory=dict)  # tests: smaller sizes on the CPU
    setup_split: Dict[str, float] = field(default_factory=dict)

    def __post_init__(self):
        self.cell = load("cells", self.cell_name)
        self.cfg = dict(load("configs", self.cell["config"])["config"],
                        **self.overrides.get("config", {}))
        self.mix = dict(load("traffic", self.cell["traffic"]), **self.overrides.get("traffic", {}))
        self._last = self.t_start or time.perf_counter()

    def lap(self, name: str) -> None:
        """Close the set-up phase `name` (seconds since the last lap)."""
        now = time.perf_counter()
        self.setup_split[name] = self.setup_split.get(name, 0.0) + now - self._last
        self._last = now

    def options(self):
        """The program's options as its entry points parse them: its
        defaults, the configuration's keys, the TEF channels; logs under
        TMPDIR."""
        from mesm_tpu_torch.config import BaseOptions

        o = BaseOptions()
        o.initialize()
        opt = o.parser.parse_args([])
        for k, v in self.cfg.items():
            setattr(opt, k, v)
        for k, v in self.mix.get("options", {}).items():
            setattr(opt, k, v)
        if opt.use_tef:
            opt.v_feat_dim += 2
        if opt.eval_batch_size == -1:
            opt.eval_batch_size = opt.batch_size
        opt.device = self.device
        opt.seed = self.seed
        tmp = os.environ.get("TMPDIR") or os.path.join(ROOT, ".portbench_tmp")
        os.makedirs(tmp, exist_ok=True)
        opt.result_dir = tmp
        opt.train_log_filepath = os.path.join(tmp, f"portbench_{self.cell_name}_train.log.txt")
        return opt

    def model(self, opt):
        """The program's model on the device, weights from the seed."""
        import torch
        from mesm_tpu_torch import runner as R

        from .weights import fill_from_seed

        with torch.device("meta"):
            model = R.build_model(opt)
        model = model.to_empty(device=self.device)
        fill_from_seed(model, self.seed)
        return model

    def reference_model(self):
        import torch

        from .reference.model import MESM, model_config
        from .weights import fill_from_seed

        with torch.device("meta"):
            ref = MESM(model_config(self.cfg))
        ref = ref.to_empty(device=self.device)
        fill_from_seed(ref, self.seed)
        return ref

    def read_per_layer(self, ctx) -> dict:
        out = {}
        for name in self.cell["per_layer"]:
            reader = load_module("metrics", name)
            value = reader.read(ctx)
            if value is not None:
                out[name] = {"value": float(value), "unit": reader.UNIT}
        return out


def plan_eval(h: Run, opt):
    """The eval cell's pass: the data set from the mix and the seed,
    batched and collated by the program's batcher and collate as its loader
    does (length-sorted where it buckets): [(host batch, meta)]."""
    from mesm_tpu_torch import runner as R
    from mesm_tpu_torch.data.collate import make_collate
    from mesm_tpu_torch.data.sampler import RowBudgetBatcher

    from . import gen

    ds = gen.Dataset(h.mix, h.cfg, h.seed, h.device)
    spec = R.make_batch_spec(opt, ds, for_eval=True)
    batcher = RowBudgetBatcher(ds, spec.row_capacity, shuffle=False, drop_single_group=False,
                               max_entries=spec.video_groups_cap)
    batcher.sort_by_length = len(spec.video_buckets) > 1
    collate = make_collate(spec)
    return [collate([ds[i] for i in idx]) for idx in batcher]


def plan_train(h: Run, opt, n: int):
    """The train cell's first `n` batches of the program's group-aware
    batcher (shuffled by the seed) at the mix's row capacity, collated:
    [(host batch, meta)]."""
    from mesm_tpu_torch import runner as R
    from mesm_tpu_torch.data.collate import make_collate
    from mesm_tpu_torch.data.sampler import GroupAwareBatcher

    from . import gen

    ds = gen.Dataset(h.mix, h.cfg, h.seed, h.device)
    spec = R.make_batch_spec(opt, ds, for_eval=False)
    collate = make_collate(spec)
    batches = []
    for idx in GroupAwareBatcher(ds, spec.row_capacity, shuffle=True, seed=h.seed):
        batches.append(collate([ds[i] for i in idx]))
        if len(batches) == n:
            break
    return batches


def kept_batches(batches, seed: int):
    """The batch each eval pass keeps for the check, pass after pass: in
    the first the fullest batch of the widest bucket, then one drawn from
    the seed."""
    import numpy as np

    rng = np.random.default_rng([int(seed), 3])
    yield max(range(len(batches)),
              key=lambda i: (batches[i][0]["video_mask"].shape[1], batches[i][1]["n_rows"]))
    while True:
        yield int(rng.integers(len(batches)))


def encode_cached(batch):
    """The frozen text encoders' output as `--cache_text on` holds it: the
    batch's cached features."""
    return batch["cached_words_feat"], batch["cached_words_mask"], batch["cached_sentence_feat"]


def host_signature(batch) -> tuple:
    import numpy as np

    return tuple(sorted((k, np.asarray(v).shape) for k, v in batch.items()))


def device_info(count: int, peak: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak)}


def compose(result: dict, device: dict) -> dict:
    """The result line's keys from a driver's result: with a traced slice,
    the device's busy and window seconds and the breakdown (the device
    operations that took most time, the idle gaps by the host operation
    open across them, at most 10 each)."""
    line = {k: result[k] for k in ("correct", "attempted", "failed", "metrics")}
    line["device"] = dict(device)
    trace = result.get("device_trace")
    if trace is not None:
        line["device"].update(busy_s=trace.busy_s, window_s=trace.window_s)
        line["breakdown"] = {"device_ops": [[n, s] for n, s in trace.top_ops(10)],
                             "idle_gaps": [[n, s] for n, s in trace.idle_gaps[:10]]}
    line["extra"] = dict(result.get("extra", {}))
    return line


def emit(result: dict, checks: Dict[str, dict]) -> None:
    """The result line, with the numbers compared beside their limits as
    its last key, and the same as the last lines on standard error."""
    result = dict(result, checks=checks)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
