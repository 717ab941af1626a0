"""The port's storage tier. So far only the columnar scan interface
(``columnar.py``) that the streaming trainer consumes; the event store
that produces it is ROADMAP.md queue 1 item 3."""
