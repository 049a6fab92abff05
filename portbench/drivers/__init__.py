"""Traffic drivers, one file a traffic kind: ``setup`` and ``window``."""
