"""Mean share of the engine's slots at work over the window, in %: each
tick's slots whose request got a token in it, weighted by the part of
the tick that lies in the window, over the slots times the window's
seconds (a stretch with no tick, the engine idle, counts as none at
work).  Read from each request's served tokens after every tick of the
whole window.  Program counter."""


def read(run):
    win = run.window
    busy_s = sum(k.busy * (min(k.t1, win.t_close) - max(k.t0, win.t_open))
                 for k in win.window_ticks() if k.t1 > win.t_open)
    return 100.0 * busy_s / (win.slots * win.seconds)
