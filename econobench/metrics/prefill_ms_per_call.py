"""Model: device ms of the prefill ranges (``engine.prefill_wave`` and
``engine.prefill_chunks``: their aten kernels and the flash kernel) per
range entered in the traced slice."""


def read(s):
    p = s.prof
    n = p.span_calls["engine.prefill_wave"] + \
        p.span_calls["engine.prefill_chunks"]
    t = p.span_s["engine.prefill_wave"] + p.span_s["engine.prefill_chunks"] \
        + p.kernel_s.get("flash", 0.0)
    return 1e3 * t / n if n and t else None
