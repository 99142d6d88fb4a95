"""CPU tests of the benchmark (and, marked ``cuda``, its runs on the card):

    python -m pytest -q bench/tests            # here
    python -m pytest -q -m cuda bench/tests    # on the card
"""
