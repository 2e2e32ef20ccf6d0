"""The toolbox's command-line drivers, each a ``main(argv)``: scene motion,
camera extraction, depth maps, and skeleton maps from a video or an image.
``python -m mikudance_tpu_torch.tools.<name> --help``."""
