"""CPU tests of the benchmark harness (toy sizes; the card's runs are
``test_portbench_card.py``, marked ``cuda``)."""
