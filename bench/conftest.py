"""Every test under ``bench/`` ends with the program's tracer off and its
record cleared, whatever it loaded or ran: a reader that armed the tracer
(``bench/program.py``) leaves nothing on for the tests after it."""
import pytest

from bench import program


@pytest.fixture(autouse=True)
def tracer_left_off():
    yield
    if program.obs is not None:
        program.obs.disable()
        program.obs.take()
    program._armed = False
    program._taken = None
