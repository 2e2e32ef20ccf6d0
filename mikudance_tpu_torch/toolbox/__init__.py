"""The preprocessing toolbox: keypoint vocabularies and renderers, camera
post-processing, XPose configs, and the networks behind the tool drivers
(Swin, CLIP-text, UniPose, DPT-hybrid, deformable attention). Stock PyTorch
ops throughout, as the JAX package's toolbox runs XLA ops only: no kernel of
``mikudance_tpu_torch.kernels`` is on this path."""
