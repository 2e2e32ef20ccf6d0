"""mikudance_tpu_torch — the MikuDance sampler in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``mikudance_tpu``, which stays in the repository as
the reference the port is held against. Same layout and module names:

- core:      configs, the reference-checkpoint <-> JAX-tree converters
- kernels:   the attention kernels (``csrc/*.cu``) and their plain versions
- models:    guidance / denoising UNets, motion modules, MAN, the SD VAE
- diffusion: zero-SNR v-prediction DDIM
- pipelines: the video sampler (cached banks, sliding windows, CFG)
- utils:     phase timing

Importing the package builds nothing and touches no device: the kernel
library is compiled by ``nvcc`` at first use on a CUDA tensor.
"""

__version__ = "0.1.0"
