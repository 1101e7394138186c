"""Benchmarking tools of the port: chained timing (timing), roofline and
kernel bounds (roofline), serving latency (serving), kernel-level
profiles of a train step (profile_step), the communication model
(comm_model) and the data-parallel scaling sweep (scaling)."""
