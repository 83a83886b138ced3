"""Share of the traced slice of validation in which no operation ran on the
device."""
from harness.readers import idle_pct


def read(record: dict):
    return idle_pct(record)
