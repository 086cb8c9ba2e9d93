"""The general generators that traffic files name (``"generator"``).

Each module gives ``setup``, ``program``, ``control``, ``warm``,
``window`` and ``check``; every parameter of a mix comes from its traffic
file and its configuration file.
"""
