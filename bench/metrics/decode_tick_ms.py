"""Mean ms of the window's engine ticks that admitted nothing: one graph
replay of the batched decode step, its sampled tokens copied to the host.
Host clock around ``engine.step()``."""


def read(run):
    ticks = [k for k in run.window.window_ticks()
             if not k.admitted and k.decoded]
    return 1e3 * sum(k.seconds for k in ticks) / len(ticks) if ticks else None
