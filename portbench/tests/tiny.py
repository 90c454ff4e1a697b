"""Small sizes of the benchmark's cells for the CPU tests: the widths and
the data set cut so that a run of a cell's driver takes seconds."""
import copy
import time

TINY_CONFIG = {"v_feat_dim": 62, "t_feat_dim": 24, "hidden_dim": 32, "dim_feedforward": 64,
               "nheads": 4, "max_video_l": 40, "vocab_size": 50}
TACOS_MIX = {"videos": 12, "sentences": 160, "duration_s": {"mean": 20, "population": 12},
             "clips": {"fps": 29.4, "frames_per_clip": 16, "max_raw": 80}}
OVERRIDES = {
    "tacos-eval": {"traffic": dict(TACOS_MIX, options={"eval_coalesce": 2,
                                                       "eval_len_buckets": 1})},
    "charades-eval": {"traffic": {"videos": 12, "sentences": 160,
                                  "duration_s": {"median": 12, "sigma": 0.4, "min": 4, "max": 40,
                                                 "tail_share": 0.1, "tail_min": 20,
                                                 "tail_max": 40},
                                  "options": {"eval_coalesce": 2, "eval_batch_size": 3}}},
    "tacos-train": {"traffic": dict(TACOS_MIX, sentences=60, batches=4,
                                    options={"row_capacity": 16})},
}


def run(cell: str, seed: int = 123456789012, fault=None, seconds: float = 0.5):
    from portbench import harness

    ov = copy.deepcopy(OVERRIDES[cell])
    ov["config"] = dict(TINY_CONFIG)
    h = harness.Run(cell, seed, seconds, False, device="cpu", t_start=time.perf_counter(),
                    fault=fault, overrides=ov)
    driver = harness.load_driver(h.cell["driver"])
    return driver.run(h)
