"""The clients that drive the program in the window, one file a driver,
named by a traffic mix's ``driver`` (``lockstep`` where it names none):
each builds the program's system (or the stand-in the run names), issues
and collects the rounds and fills the harness's ``Run``
(``portbench/harness.py`` lists the calls a driver has)."""
