"""inferd_tpu_torch.perf: what the card allows, and where a step's time goes
(port of inferd_tpu/perf).

  * roofline: the analytic cost of one decode step (bytes and FLOPs) for a
    ModelConfig x quant mode x KV dtype x context x batch, against a chip
    table with the H100's published peaks: the floor ms per step, the
    ceiling tok/s and the roofline share of a measured rate.
  * anatomy: times one decode step's phases (embed, attention, mlp,
    lm_head, sampling, kv_write) as captured CUDA graphs of a short and a
    long loop, differenced in interleaved pairs, each beside its bound; the
    whole graphed step; and `dispatch`, what the host-driven eager step
    costs beyond it.

CLI: `python -m inferd_tpu_torch.perf {report,anatomy}` (see __main__).
`check` and the gate over benchmark artifacts wait for perf/gate.py.

No module here touches a CUDA device when it is imported.
"""
