"""Query planning: wire, plans, engine and the strict oracle."""
