"""Engine core: tables, relational operators, plans, planner, backends."""
