"""Training core: configuration, schedules, EMA, optimizer and the train step."""
