"""The accepted step times of each answer a program gave, kept by the
answer's final time, for a reference that marches on the answer's steps.

Where the answer depends on the steps themselves, and not only on the
time reached, a reference with its own step controller cannot judge a
lower-precision program: the program's controller reads its error norm
through its own rounding and takes other steps. The immersed-boundary
loop is such a case (it corrects the velocity once per accepted step). Its
program module records here the times each replay accepted, and its
reference marches on them, holding each step to its own error test.

The program and the judge run in one process, so this plain module
(imported as `reference.answer_steps`, once per process) carries the
times from one to the other.
"""
from __future__ import annotations

#: final time -> the accepted step times of the march that ended there
#: (None where two marches ended at the same time on other steps)
TIMES: dict = {}


def record(times) -> None:
    """Keep a march's accepted step times (increasing) under its last."""
    times = tuple(float(t) for t in times)
    if not times:
        return
    end = times[-1]
    TIMES[end] = times if TIMES.get(end, times) == times else None


def of(t_end: float):
    """The accepted step times of the march that ended at `t_end`, or None
    where none, or more than one, was recorded."""
    return TIMES.get(float(t_end))
