"""Upstream's host-side stages in NumPy, from the semantics of the
reference kernels and of executeCPUTask, written apart from the port: the
polyline stage (oclpolyline.cl/.c: strings morphology, chain numbering,
arc labels, mkpl's subdivision, refine), the boundary labels and the
reduceLS table (oclrect.cl), and the hypotheses, their quad reduction and
the pose (oclrect.c:385-1226).  Lists grow as upstream's do: there is no
capacity anywhere, so a frame whose groups, segments or members exceed a
capacity of the port shows as a difference.

It follows golden/'s loop-level NumPy transcription of those kernels,
with its deterministic stand-ins for the reference's scheduling (labels
are the least flat index of a component, mkpl's argmax ties go to the
least flat index, new segment ids come in segment order, the reduceLS
table is claimed in raster order), vectorised over pixels; the per-group
reduction and the screen test are golden's loop code, copied, and the
pose its float64 conjugate gradient, batched over groups.  Nothing here
reads golden/ or the port."""
