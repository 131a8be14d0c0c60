"""The plain reference the benchmark's check holds the program to, and the
comparison that decides `correct`. Imports nothing of the program."""
