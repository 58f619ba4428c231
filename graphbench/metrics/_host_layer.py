"""Shared by the host-time readers: the sampled thread-seconds whose
innermost frame in dgraph_tpu_torch/ lies in one of a layer's modules, in
ms per request completed in the window."""


def ms_per_query(w, modules: tuple[str, ...]):
    if w.completed <= 0 or not w.host_seconds:
        return None
    total = sum(s for label, s in w.host_seconds.items()
                if label.split(":", 1)[0].startswith(modules))
    return 1e3 * total / w.completed
