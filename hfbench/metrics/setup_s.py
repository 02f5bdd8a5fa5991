"""setup_s: the seconds from the process's start to the first timed pass:
imports, the kernel library's load (its build in a checkout's first run),
the problem's build, the warm pass and the draws."""


def read(run):
    return run.setup_s
