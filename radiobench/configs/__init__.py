"""Configurations: a JSON file of sizes and the code of its graph each."""
