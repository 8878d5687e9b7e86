"""Deployment: ``stage`` builds the asset tree a serving host mounts
(every checkpoint converted once, into the port's native format) and
``render`` writes the image and pool artifacts around it.  Both run
offline and touch no GPU."""
