"""One module per driver: a traffic file names the driver it needs. A
driver's ``Driver(cell, seed, device, overrides)`` has ``setup()``,
``window(seconds)``, ``trace()`` and ``check()``."""
