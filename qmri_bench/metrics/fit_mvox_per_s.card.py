"""fit_mvox_per_s.card: fit_mvox_per_s of the main path's cell alone. Its runs
spread by about a third of the host-bound fit cells' (1.90% against 5.72%
at one host thread), so it carries a bound of its own; the per-layer
metrics move the shared fit_mvox_per_s."""

from qmri_bench.run import reader

read = reader("fit_mvox_per_s")
