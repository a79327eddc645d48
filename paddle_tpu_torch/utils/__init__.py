"""Small shared helpers, and the legacy fluid profiler aliases over
`paddle_tpu_torch.profiler` (paddle_tpu's `utils.compat` Profiler,
ProfilerOptions and get_profiler)."""


class ProfilerOptions:
    def __init__(self, options=None):
        self.options = options or {}


def Profiler(*a, **kw):
    from .. import profiler as prof
    return prof.Profiler(*a, **kw) if hasattr(prof, "Profiler") else prof


def get_profiler(*a, **kw):
    from .. import profiler as prof
    return prof
