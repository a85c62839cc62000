"""Runtime helpers the simulator's scenarios use: straggler detection and
the bounded-staleness queue (``runtime/straggler.py``)."""
