"""Runtime: straggler detection and the bounded-staleness queue the
simulator's scenarios use (``straggler``), the fault-tolerant training
driver (``driver``) and the elastic trainer that carries out an OASiS
schedule (``elastic``)."""
