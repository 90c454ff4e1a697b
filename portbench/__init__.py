"""The benchmark of the PyTorch and CUDA port (`mesm_tpu_torch`).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell once on a CUDA card and prints one JSON line (run.py). A cell
is `cells/<cell>.json`: a configuration (`configs/`), a traffic mix
(`traffic/`, read by the one generator `gen.py`), a driver (`drivers/`),
its per-layer metrics (one reader each in `metrics/`) and the limits of its
correctness check (`checks.py` against the plain reference in
`reference/`). The counts of operations and bytes and the table of peaks
are in `counts/`. `control.py` and `faults.py` read the check's control and
faults on the card; `tests/` are the CPU tests (`python -m pytest
portbench/tests -q`; on the card add `-m cuda`).
"""
