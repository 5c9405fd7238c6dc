"""The benchmark of ``stencil_tpu_torch`` on one NVIDIA H100: its cells,
their plain reference, the frozen roofline count and the device-timeline
reader. ``python3 benchmark/run.py --help`` runs a cell."""
