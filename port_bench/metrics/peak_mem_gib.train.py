"""Peak of the card's allocated memory over the training window
(``torch.cuda.max_memory_allocated`` after a reset at its start)."""
from harness.readers import peak_gib


def read(record: dict):
    return peak_gib(record)
