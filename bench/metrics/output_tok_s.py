"""Output tokens produced in the window divided by the window's seconds.
Host clock."""


def read(run):
    win = run.window
    n = sum(1 for s in win.served for t in s.times if win.in_window(t))
    return n / win.seconds
