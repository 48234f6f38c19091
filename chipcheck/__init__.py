"""The checks that ``chip_smoke.py`` runs on the card, one module a group of phases."""
