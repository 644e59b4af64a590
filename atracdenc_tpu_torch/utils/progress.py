"""Console progress spinner (reference: src/main.cpp:67-74, 704)."""
import sys

_SYMBOLS = "-\\|/"
_counter = 0


def print_progress(percent: int) -> None:
    global _counter
    _counter += 1
    sys.stdout.write(f"{_SYMBOLS[_counter % 4]}  {percent}% done\r")
    sys.stdout.flush()
