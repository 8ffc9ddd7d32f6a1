"""The port's measurement programs: counterparts of the repository's
``scripts/perf_probe.py``, ``scripts/stage_probe.py``,
``scripts/trace_render.py`` and ``scripts/make_demos.py``, each run as
``python -m topo_renderer_tpu_torch.scripts.<name>``."""
