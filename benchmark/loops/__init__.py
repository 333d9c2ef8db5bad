"""One loop per kind of traffic: set-up, the timed window, the comparison."""
