"""The cluster autoscaler: node groups and the simulated provisioner
(``nodegroups``), the what-if over virtual node columns (``simulator``)
and the control loop (``controller``)."""
