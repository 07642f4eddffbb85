"""Model families: one module each, named by a configuration's
``family_module`` and loaded by ``harness.cell.load_family``."""
