"""Mean ms of the window's engine ticks that admitted at least one
request (its bucketed prefills, then the decode step).  Host clock around
``engine.step()``."""


def read(run):
    ticks = [k for k in run.window.window_ticks() if k.admitted]
    return 1e3 * sum(k.seconds for k in ticks) / len(ticks) if ticks else None
