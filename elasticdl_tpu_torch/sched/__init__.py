"""The reference's policy plane (`elasticdl_tpu/sched/`); only its phase
telemetry (`sched/telemetry.py`) is ported."""
