"""v1_refresh_s (s): the host clock around the program's V1 refresh
(``repro_torch.core.lowrank.refresh_projections``) in set-up, ended by a
synchronise.  Nothing to read where the cell runs no refresh (the healthy
program).  Moves ``setup_s``."""


def read(run):
    return run.spans.get("v1_refresh_s")
