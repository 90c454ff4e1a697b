"""MESM on PyTorch and CUDA for one NVIDIA H100: the port of the JAX package
`mesm_tpu`, which stays the reference it is tested against.

Layout mirrors `mesm_tpu`: `config`, `runner`, `evaluate`
(`python -m mesm_tpu_torch.evaluate`), `convert`, `models/`, `ops/` (with the
wrappers of the CUDA kernels and their plain torch versions), `kernels/`
(dispatch, nvcc build, CUDA sources), `parallel/step.py`, `data/`,
`metrics`, `postprocess`. Nothing here imports JAX or `mesm_tpu`.
"""
